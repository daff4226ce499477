"""Headline benchmark: canonical k-mers counted per second on one GPU.

Replicates the reference's headline workload shape (ecoli-scale genome,
k=51 — reference README.md example) with synthetic reads and measures
the full single-device pipeline end to end: host 2-bit pack -> transfer
-> canonical window extraction -> global sort -> segment-reduce merge
into the distinct-kmer store (and, for skm, the finalize expansion).

The device queue is drained with real data fetches before the clock
stops.  Runs only on a GPU; the output names the device.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "kmers/s", "vs_baseline": N,
   "device": {...}, ...}
vs_baseline is against the target of 1e9 canonical k-mers/s per device
(BASELINE.md rebuild targets).

``--trace DIR`` additionally traces one warm run with jax.profiler and
prints its wall time and per-stage device time (segmentation + packing,
merge sort, compaction, finalize); see ``stage_times`` for the XLA flag
it needs.
"""

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

# named scopes set in ops/skm.py and ops/sortcount.py, in match order
STAGES = ("segpack", "compact")


def make_reads(genome_mb: float, coverage: int, read_len: int, seed: int = 0):
    """Synthetic genome + reads sampled at the given coverage, as one
    plain-text code stream (reads separated by resets)."""
    rng = np.random.default_rng(seed)
    glen = int(genome_mb * 1e6)
    genome = rng.integers(0, 4, size=glen, dtype=np.int64).astype(np.uint8)
    n_reads = glen * coverage // read_len
    starts = rng.integers(0, glen - read_len, size=n_reads)
    offs = np.arange(read_len)
    reads = genome[starts[:, None] + offs[None, :]]  # (n_reads, read_len)
    stream = np.full((n_reads, read_len + 1), 4, np.uint8)
    stream[:, :read_len] = reads
    return stream.reshape(-1)


def stage_times(trace_dir: str) -> dict:
    """Device seconds per stage on the GPU compute stream of a
    jax.profiler trace (trace with XLA_FLAGS=--xla_gpu_enable_command_
    buffer= so kernels are not folded into CUDA-graph launches):

    - programs whose module name has "expand" (ops/skm.py finalize
      steps) are the finalize;
    - other kernels go to the first STAGES scope in their op_name (the
      event's "name" stat, e.g. "jit(skm_superstep)/segpack/...");
    - sort kernels carry no op_name; in each program the first sort
      instruction (lowest id in "sort_<id>_...") is the merge sort and
      later ones are the compaction's stable partition;
    - "busy" is the sum of all kernel time, "other" what is left."""
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    acc, sorts = {}, {}
    for plane in ProfileData.from_file(paths[-1]).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if "Compute" not in line.name:
                continue
            for ev in line.events:
                st = dict(ev.stats)
                if "hlo_op" not in st:
                    continue
                dt = ev.duration_ns * 1e-9
                acc["busy"] = acc.get("busy", 0.0) + dt
                module = str(st.get("hlo_module"))
                scopes = str(st.get("name", "")).split("/")
                if "expand" in module:
                    stage = "finalize"
                elif ev.name.startswith("sort_"):
                    key = (module, st.get("program_id"),
                           int(ev.name.split("_")[1]))
                    sorts[key] = sorts.get(key, 0.0) + dt
                    continue
                else:
                    stage = next((s for s in STAGES if s in scopes), "other")
                acc[stage] = acc.get(stage, 0.0) + dt
    first = {}
    for module, pid, sid in sorts:
        first[(module, pid)] = min(sid, first.get((module, pid), sid))
    for (module, pid, sid), dt in sorts.items():
        stage = "merge_sort" if sid == first[(module, pid)] else "compact"
        acc[stage] = acc.get(stage, 0.0) + dt
    return acc


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=51)
    ap.add_argument("--genome-mb", type=float, default=4.6)
    ap.add_argument("--coverage", type=int, default=30,
                    help="read coverage depth (30x = standard Illumina "
                         "sequencing depth)")
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--batch-log2", type=int, default=23)
    ap.add_argument("--rows-log2", type=int, default=12)
    ap.add_argument("--superbatch", type=int, default=None,
                    help="device batches fused per superstep dispatch "
                         "(default: 16 for skm, 4 for classic, whose merge "
                         "sorts the full window mass)")
    ap.add_argument("--merge-every", type=int, default=2)
    ap.add_argument("--prefix-log2", type=int, default=23,
                    help="initial distinct-store capacity (log2); 2^23 matches "
                         "the reference README's own -s 8000000 sizing for this "
                         "workload (growth-replay would otherwise double work)")
    ap.add_argument("--repeats", type=int, default=5,
                    help="timed end-to-end repeats; the headline is the "
                         "MEDIAN with min and spread reported alongside")
    ap.add_argument("--scale", type=int, default=10,
                    help="coverage multiplier: the default 10 measures the "
                         "steady state (finalize, first transfer and tail "
                         "amortized; the distinct set is unchanged); "
                         "--scale 1 is plain 30x")
    ap.add_argument("--no-crosscheck", action="store_true",
                    help="skip the classic-pipeline distinct-equality "
                         "cross-check run")
    ap.add_argument("--transfer-group", type=int, default=None,
                    help="superbatches per host->device copy (default: "
                         "1 for skm, 4 for classic)")
    ap.add_argument("--winkeys", default="codes",
                    help="window-key extraction (codes/packed)")
    ap.add_argument("--pipeline", default="skm",
                    help="counting pipeline: skm (minimizer-run dedup, "
                         "ops/skm.py) or classic (one sorted row per window)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="trace one extra warm run into DIR and print "
                         "per-stage device time")
    args = ap.parse_args()

    import jax

    from kaarme_tpu.models.sort_counter import SortCounterConfig, SortKmerCounter
    from kaarme_tpu.utils.compile_cache import enable_compile_cache
    from kaarme_tpu.utils.device import card_name_and_power_limit, require_gpu

    dev = require_gpu()
    device = {"platform": dev.platform, "device_kind": dev.device_kind,
              "device_count": len(jax.devices()),
              "nvidia_smi": card_name_and_power_limit()}
    enable_compile_cache()

    k = args.k
    if args.superbatch is None:
        args.superbatch = 16 if args.pipeline == "skm" else 4
    if args.transfer_group is None:
        args.transfer_group = 1 if args.pipeline == "skm" else 4
    coverage = args.coverage * args.scale
    codes = make_reads(args.genome_mb, coverage, args.read_len)
    n_windows = int((codes.shape[0] // (args.read_len + 1))
                    * (args.read_len - k + 1))

    def drain(tree):
        for leaf in jax.tree_util.tree_leaves(tree):
            np.asarray(leaf[:1])

    common = dict(
        k=k, batch_windows=1 << args.batch_log2, rows=1 << args.rows_log2,
        merge_every=args.merge_every, superbatch_batches=args.superbatch,
        prefix_cap=1 << args.prefix_log2, min_abundance=2,
        transfer_group=args.transfer_group, winkeys=args.winkeys,
    )
    if args.pipeline == "skm":
        from kaarme_tpu.models.skm_counter import SkmCounter, SkmCounterConfig

        def make_counter():
            return SkmCounter(SkmCounterConfig(**common))
    else:
        def make_counter():
            return SortKmerCounter(SortCounterConfig(**common))

    def run_once():
        c = make_counter()
        t0 = time.perf_counter()
        c.count_codes(codes)
        if args.pipeline == "skm":
            # include the finalize expansion (device-side, like the
            # classic pipeline's end state: a device-resident sorted
            # k-mer store; host OUTPUT transfer is excluded for both)
            store, _nd = c.finalize_device()
            drain(store)
        drain(c.prefix)
        dt = time.perf_counter() - t0
        return dt, c

    # warm-up / compile
    t0 = time.perf_counter()
    _, counter = run_once()
    cold_s = time.perf_counter() - t0

    times = []
    for _ in range(args.repeats):
        dt, counter = run_once()
        times.append(dt)
    peak = dev.memory_stats()["peak_bytes_in_use"]
    times.sort()
    t_med = times[len(times) // 2] if len(times) % 2 else \
        0.5 * (times[len(times) // 2 - 1] + times[len(times) // 2])
    t_min = times[0]
    spread_pct = 100.0 * (times[-1] - times[0]) / t_med if t_med else 0.0

    # exact finalized distinct k-mers (the run-store n_distinct counts
    # RUNS for the skm pipeline)
    if args.pipeline == "skm":
        distinct = counter.distinct_kmers()
    else:
        distinct = counter.n_distinct

    stages = None
    if args.trace:
        with jax.profiler.trace(args.trace):
            stages = {"wall": run_once()[0]}
        stages.update(stage_times(args.trace))
        print(f"# stage device seconds per traced run: {stages}",
              file=sys.stderr)

    # the skm distinct set must equal the classic pipeline's
    crosscheck = None
    if args.pipeline == "skm" and not args.no_crosscheck:
        # classic-safe superstep sizing: its merge sorts the FULL
        # window mass
        classic_common = dict(common, superbatch_batches=4,
                              transfer_group=4)
        c2 = SortKmerCounter(SortCounterConfig(**classic_common))
        c2.count_codes(codes)
        drain(c2.prefix)
        crosscheck = bool(c2.n_distinct == distinct)
        print(f"# crosscheck classic distinct={c2.n_distinct} "
              f"skm distinct={distinct} equal={crosscheck}",
              file=sys.stderr)

    kmers_per_s = n_windows / t_med
    print(
        f"# device={dev} windows={n_windows} "
        f"median={t_med:.3f}s min={t_min:.3f}s spread={spread_pct:.0f}% "
        f"distinct_kmers={distinct} k={k} "
        f"batches={counter.stats['batches']} "
        f"merges={counter.stats['compactions']}",
        file=sys.stderr,
    )
    out = {
        "metric": "canonical_kmers_per_sec_per_device",
        "value": kmers_per_s,
        "unit": "kmers/s",
        "vs_baseline": kmers_per_s / 1e9,
        "device": device,
        "workload": f"{args.genome_mb}MB genome x{coverage} coverage "
                    f"rl{args.read_len} k{k} {args.pipeline}",
        "cold_s": cold_s,
        "median_s": t_med,
        "min_s": t_min,
        "spread_pct": spread_pct,
        "best_kmers_per_s": n_windows / t_min,
        "windows": n_windows,
        "distinct_kmers": int(distinct),
        "peak_bytes_in_use": peak,
    }
    if stages is not None:
        out["stage_device_s"] = stages
    if crosscheck is not None:
        out["distinct_matches_classic"] = crosscheck
    print(json.dumps(out))


if __name__ == "__main__":
    sys.exit(main())
