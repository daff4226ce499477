"""BASELINE config-matrix benchmark: median of >= 3 timed repeats with
spread, true distinct k-mers, skm -b row, and a 10x coverage-scaled
steady-state row.

Runs the headline workload family across the config matrix on the GPU
and writes a JSON file:

  - k = 31 / 51 / 63 (short, headline, multi-word packing)
  - mode 0 (plain-table output clipping semantics)
  - Bloom mode (-b): classic AND skm compositions
  - pipeline = classic vs skm at the headline k
  - skm at 10x the coverage (fixed costs amortized, same distinct set)

Usage: python scripts/bench_matrix.py [--out bench_matrix.json]
       [--genome-mb 4.6 --coverage 30] [--quick]
"""

import argparse
import json
import time

import numpy as np

import os
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="bench_matrix.json")
    ap.add_argument("--genome-mb", type=float, default=4.6)
    ap.add_argument("--coverage", type=int, default=30)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--quick", action="store_true",
                    help="1 repeat, skip k=63")
    args = ap.parse_args()
    if args.quick:
        args.repeats = 1

    import jax

    from kaarme_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from bench import make_reads
    from kaarme_tpu.models.sort_counter import (SortCounterConfig,
                                                SortKmerCounter)

    codes = make_reads(args.genome_mb, args.coverage, args.read_len)

    def drain(tree):
        for leaf in jax.tree_util.tree_leaves(tree):
            np.asarray(leaf[:1])

    def windows(k):
        return int((codes.shape[0] // (args.read_len + 1))
                   * (args.read_len - k + 1))

    def run(make, k, finalize=False, data=None):
        data = codes if data is None else data
        times = []
        counter = None
        for rep in range(args.repeats + 1):   # +1 warmup/compile
            c = make()
            t0 = time.perf_counter()
            c.count_codes(data)
            if finalize:
                # device-side finalize (host output transfer excluded,
                # matching the classic rows' device-resident end state)
                store, _nd = c.finalize_device()
                drain(store)
            drain(c.prefix)
            dt = time.perf_counter() - t0
            if rep:
                times.append(dt)
            counter = c
        times.sort()
        med = times[len(times) // 2] if len(times) % 2 else \
            0.5 * (times[len(times) // 2 - 1] + times[len(times) // 2])
        spread = 100.0 * (times[-1] - times[0]) / med if med else 0.0
        return med, times[0], spread, counter

    results = {"device": str(jax.devices()[0]),
               "workload": {"genome_mb": args.genome_mb,
                            "coverage": args.coverage,
                            "read_len": args.read_len}}

    common = dict(batch_windows=1 << 23, rows=1 << 12,
                  superbatch_batches=4, prefix_cap=1 << 23,
                  min_abundance=2)

    ks = [51, 31] if args.quick else [51, 31, 63]
    for k in ks:
        def mk(k=k):
            return SortKmerCounter(SortCounterConfig(k=k, **common))
        dt, tmin, spread, c = run(mk, k)
        results[f"classic_k{k}"] = {
            "seconds_median": round(dt, 3), "seconds_min": round(tmin, 3),
            "spread_pct": round(spread, 1),
            "kmers_per_s": round(windows(k) / dt),
            "distinct_kmers": int(c.n_distinct)}
        print(f"classic k={k}: {dt:.2f}s -> "
              f"{windows(k)/dt/1e6:.1f}M/s", flush=True)
        json.dump(results, open(args.out, "w"), indent=1)

    # mode 0 (uint16-wrap clipping — output-time only, same pipeline)
    def mk0():
        return SortKmerCounter(SortCounterConfig(k=51, mode=0, **common))
    dt, tmin, spread, c = run(mk0, 51)
    results["mode0_k51"] = {"seconds_median": round(dt, 3),
                            "spread_pct": round(spread, 1),
                            "kmers_per_s": round(windows(51) / dt)}
    print(f"mode0 k=51: {dt:.2f}s", flush=True)
    json.dump(results, open(args.out, "w"), indent=1)

    # skm pipeline (incl. finalize expansion)
    from kaarme_tpu.models.skm_counter import SkmCounter, SkmCounterConfig

    def mks():
        return SkmCounter(SkmCounterConfig(k=51, **common))
    dt, tmin, spread, c = run(mks, 51, finalize=True)
    results["skm_k51"] = {
        "seconds_median": round(dt, 3), "seconds_min": round(tmin, 3),
        "spread_pct": round(spread, 1),
        "kmers_per_s": round(windows(51) / dt),
        "distinct_kmers": int(c.distinct_kmers()),
        "distinct_runs": int(c.n_distinct)}
    print(f"skm k=51: {dt:.2f}s -> {windows(51)/dt/1e6:.1f}M/s", flush=True)
    json.dump(results, open(args.out, "w"), indent=1)

    # skm at 10x coverage: the steady-state row (fixed costs — finalize,
    # first transfer, tail — amortized; distinct set identical)
    if not args.quick:
        data10 = make_reads(args.genome_mb, args.coverage * 10,
                            args.read_len)
        nwin10 = int((data10.shape[0] // (args.read_len + 1))
                     * (args.read_len - 51 + 1))
        dt, tmin, spread, c = run(mks, 51, finalize=True, data=data10)
        results["skm_k51_10x"] = {
            "seconds_median": round(dt, 3), "seconds_min": round(tmin, 3),
            "spread_pct": round(spread, 1),
            "kmers_per_s": round(nwin10 / dt),
            "windows": nwin10,
            "distinct_kmers": int(c.distinct_kmers())}
        print(f"skm k=51 10x: {dt:.2f}s -> {nwin10/dt/1e6:.1f}M/s",
              flush=True)
        json.dump(results, open(args.out, "w"), indent=1)

    # Bloom mode (-b -u: two-pass prefilter, sort backend) — BASELINE
    # config 3.  The workload's ~4.6M distinct at 30x coverage leaves
    # few singletons; also run a low-coverage variant where the filter
    # actually drops mass.
    from kaarme_tpu.models.bloom_counter import (bloom_skm_count_codes,
                                                 bloom_sort_count_codes)
    from kaarme_tpu.models.skm_counter import SkmCounterConfig as _SkmCfg

    for tag, cov in (("30x", None), ("4x", 4)):
        data = codes if cov is None else make_reads(
            args.genome_mb, cov, args.read_len)
        nwin = int((data.shape[0] // (args.read_len + 1))
                   * (args.read_len - 51 + 1))
        best = float("inf")
        for rep in range(args.repeats + 1):
            cfg = SortCounterConfig(k=51, **common)
            t0 = time.perf_counter()
            c = bloom_sort_count_codes(cfg, 4_000_000, 0.01, data)
            drain(c.prefix)
            dt = time.perf_counter() - t0
            if rep:
                best = min(best, dt)
        results[f"bloom_k51_{tag}"] = {
            "seconds": round(best, 3),
            "kmers_per_s": round(nwin / best)}
        print(f"bloom k=51 {tag}: {best:.2f}s -> "
              f"{nwin/best/1e6:.1f}M/s", flush=True)
        json.dump(results, open(args.out, "w"), indent=1)

    # skm -b (round-5 composition: BF2 gate at finalize expansion)
    nwin = windows(51)
    best = float("inf")
    for rep in range(args.repeats + 1):
        cfg = _SkmCfg(k=51, **common)
        t0 = time.perf_counter()
        c = bloom_skm_count_codes(cfg, 4_000_000, 0.01, codes)
        store, _ = c.finalize_device()
        drain(store)
        dt = time.perf_counter() - t0
        if rep:
            best = min(best, dt)
    results["bloom_skm_k51_30x"] = {
        "seconds": round(best, 3),
        "kmers_per_s": round(nwin / best)}
    print(f"bloom skm k=51: {best:.2f}s -> {nwin/best/1e6:.1f}M/s",
          flush=True)
    json.dump(results, open(args.out, "w"), indent=1)

    print(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
