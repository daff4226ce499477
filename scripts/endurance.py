"""Scale endurance run: a >= 1 GB chr20-shaped synthetic FASTA streamed
through the single-device counter with the production merge cadence, a
mid-run checkpoint + resume with output equality, wall/memory/grow
accounting.

    python scripts/endurance.py [--gb 1.0] [--pipeline skm|classic]
    python scripts/endurance.py --mesh   # same workload, 8-dev virtual CPU mesh

Results are written to --out, merging into an existing file so the
device run and the mesh run land in one file.
"""

import argparse
import json
import os
import time

import numpy as np

import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_fasta(path: str, gb: float, seed: int = 0,
               read_len: int = 150, glen: int = 40_000_000):
    """chr20-shaped: one long genome sampled at coverage to ~gb bytes."""
    rng = np.random.default_rng(seed)
    lut = np.frombuffer(b"ACGT", np.uint8)
    genome = rng.integers(0, 4, size=glen, dtype=np.int64).astype(np.uint8)
    per_rec = read_len + 9            # ~9 B header/newlines
    n_reads = int(gb * 1e9 / per_rec)
    with open(path, "wb") as f:
        buf = []
        for i in range(n_reads):
            s = int(rng.integers(0, glen - read_len))
            buf.append(b">r%d\n" % i)
            buf.append(lut[genome[s: s + read_len]].tobytes())
            buf.append(b"\n")
            if len(buf) >= 3000:
                f.write(b"".join(buf))
                buf = []
        f.write(b"".join(buf))
    return os.path.getsize(path)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gb", type=float, default=1.0)
    ap.add_argument("--pipeline", default="skm",
                    choices=("classic", "skm"))
    ap.add_argument("--out", default="endurance.json")
    ap.add_argument("--k", type=int, default=51)
    ap.add_argument("--mesh", action="store_true",
                    help="run on the 8-device virtual CPU mesh instead "
                         "(set JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_"
                         "host_platform_device_count=8)")
    ap.add_argument("--checkpoint-at", type=float, default=0.5,
                    help="fraction of chunks after which to snapshot")
    ap.add_argument("--fasta", default="/tmp/endurance.fasta")
    ap.add_argument("--prefix-log2", type=int, default=23,
                    help="initial distinct-store capacity (log2): pre-size "
                         "for the expected distinct count — every growth "
                         "event at a new capacity costs a fresh superstep "
                         "compile")
    args = ap.parse_args()

    def emit(key, value):
        data = {}
        if os.path.exists(args.out):
            data = json.load(open(args.out))
        data[key] = value
        json.dump(data, open(args.out, "w"), indent=1)
        print(f"# {key}: {json.dumps(value)}", flush=True)

    import jax

    from kaarme_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from kaarme_tpu.io import reader as io_reader

    if not os.path.exists(args.fasta) or \
            os.path.getsize(args.fasta) < args.gb * 0.95e9:
        t0 = time.time()
        sz = make_fasta(args.fasta, args.gb)
        print(f"generated {sz/1e9:.2f} GB fasta in {time.time()-t0:.0f}s",
              flush=True)
    size = os.path.getsize(args.fasta)

    k = args.k
    if args.mesh:
        from kaarme_tpu.parallel.sharded import make_mesh
        from kaarme_tpu.parallel.sharded_sort import (ShardedSortConfig,
                                                      ShardedSortCounter)

        cfg = ShardedSortConfig(k=k, batch_windows=1 << 20, rows=1 << 10,
                                prefix_cap=1 << 20, min_abundance=2)
        c = ShardedSortCounter(cfg, make_mesh(8))
        t0 = time.time()
        c.count_file(args.fasta)
        keys, cnt = c.dump()
        wall = time.time() - t0
        emit("mesh8_virtual", {
            "gb": round(size / 1e9, 3), "k": k,
            "wall_s": round(wall, 1),
            "distinct_kmers": int(keys.shape[0]),
            "grow_events": int(c.stats["grow_events"])})
        return

    if args.pipeline == "skm":
        from kaarme_tpu.models.skm_counter import SkmCounter, SkmCounterConfig

        def mk():
            return SkmCounter(SkmCounterConfig(
                k=k, batch_windows=1 << 23, rows=1 << 12,
                superbatch_batches=4, prefix_cap=1 << args.prefix_log2,
                min_abundance=2))
    else:
        from kaarme_tpu.models.sort_counter import (SortCounterConfig,
                                                    SortKmerCounter)

        def mk():
            return SortKmerCounter(SortCounterConfig(
                k=k, batch_windows=1 << 23, rows=1 << 12,
                superbatch_batches=4, prefix_cap=1 << args.prefix_log2,
                min_abundance=2))

    # pass 1: straight streaming run
    c = mk()
    t0 = time.time()
    c.count_file(args.fasta)
    if args.pipeline == "skm":
        c.finalize_device()
    wall = time.time() - t0
    nwin = c.stats["windows_processed"]
    distinct = c.distinct_kmers() if args.pipeline == "skm" \
        else c.n_distinct
    try:
        mem = jax.local_devices()[0].memory_stats() or {}
        peak_hbm = int(mem.get("peak_bytes_in_use", 0))
    except Exception:
        peak_hbm = 0
    print(f"straight: {wall:.0f}s {nwin/wall/1e6:.1f}M w/s "
          f"windows={nwin} distinct={distinct} "
          f"grow={c.stats['grow_events']} "
          f"compactions={c.stats['compactions']}", flush=True)
    out1 = "/tmp/endurance1.out"
    t0w = time.time()
    nlines = c.write_output(out1)
    t_write = time.time() - t0w
    straight = {
        "gb": round(size / 1e9, 3), "k": k, "pipeline": args.pipeline,
        "device": str(jax.devices()[0]),
        "wall_s": round(wall, 1),
        "window_positions": int(nwin),
        # valid windows: reads are 150 bp + 1 separator, so (rl-k+1) of
        # every (rl+1) positions form real windows — the honest rate
        "valid_windows_est": int(nwin * (150 - k + 1) // 151),
        "kmers_per_s": round(nwin * (150 - k + 1) // 151 / wall),
        "distinct_kmers": int(distinct),
        "grow_events": int(c.stats["grow_events"]),
        "slot_grow_events": int(c.stats.get("slot_grow_events", 0)),
        "compactions": int(c.stats["compactions"]),
        "peak_hbm_bytes": peak_hbm,
        "output_lines": int(nlines),
        "output_write_s": round(t_write, 1),
    }

    # pass 2: checkpoint mid-run, resume in a FRESH counter, must match
    c2 = mk()
    ckpt = "/tmp/endurance_ckpt.npz"
    chunks = io_reader.CodeChunkReader(args.fasta)
    t0 = time.time()
    done = 0
    total_bytes = 0
    snap_at = args.checkpoint_at * size
    snapped = False
    for codes in io_reader.PrefetchingReader(chunks, depth=4):
        c2.add_codes(codes)
        total_bytes += codes.shape[0]
        if not snapped and total_bytes >= snap_at * 0.9:
            c2.save(ckpt)
            print(f"checkpointed at ~{total_bytes/1e9:.2f} GB "
                  f"({time.time()-t0:.0f}s in)", flush=True)
            snapped = True
            break
    # resume from disk and feed the REST of the stream
    cls = type(c2)
    c3 = cls.load(ckpt, mk().cfg)
    consumed = c2.stats["windows_processed"]
    del c2
    skipped = 0
    for codes in io_reader.CodeChunkReader(args.fasta):
        # re-stream: skip bytes already inside the checkpoint (the tail
        # is stored verbatim in the snapshot)
        take = codes
        if skipped + codes.shape[0] <= total_bytes:
            skipped += codes.shape[0]
            continue
        if skipped < total_bytes:
            take = codes[total_bytes - skipped:]
            skipped = total_bytes
        c3.add_codes(take)
    c3.finish()
    out2 = "/tmp/endurance2.out"
    c3.write_output(out2)
    same = open(out1, "rb").read() == open(out2, "rb").read()
    print(f"checkpoint/resume output equality: {same}", flush=True)
    straight["checkpoint_resume_equal"] = bool(same)
    straight["checkpoint_at_gb"] = round(total_bytes / 1e9, 3)
    emit(f"chip_{args.pipeline}", straight)
    assert same


if __name__ == "__main__":
    main()
