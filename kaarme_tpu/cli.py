"""Command-line interface.

Mirrors the reference CLI surface (reference: main.cpp:127-156) so the
README examples run unchanged:

    kaarme_tpu INPUT KLEN [-m MODE] [-a MINABU] [-t THREADS] [-o OUT]
               (-s SLOTS | -u UNIQUE) [-b] [-f FPR]

- INPUT: fasta / plain one-string-per-line, optionally gzipped (sniffed);
- -s / -u are mutually exclusive and one is required;
- -b (Bloom prefilter that discards unique k-mers) requires -u, -f
  requires -b (reference: main.cpp:144-151);
- default output: <input stem>.kaarme_counts (reference: main.cpp:189-191);
- -t is accepted for compatibility; it sizes the host prefetch depth
  (device parallelism replaces worker threads).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kaarme_tpu", description="Space-efficient k-mer counter (JAX/XLA)"
    )
    p.add_argument("INPUT", help="Input file (automatic format detection)")
    p.add_argument("KLEN", type=int, help="k-mer length")
    p.add_argument("-m", "--hash-table-type", type=int, default=2, choices=(0, 1, 2),
                   help="Hash table type: 0 for plain and 2 for kaarme (def. 2). "
                        "1 (the reference's undocumented legacy variant of the "
                        "kaarme table with identical counting semantics — "
                        "SURVEY.md section 2.3) is accepted as an alias for 2.")
    p.add_argument("-a", "--min-k-abu", type=int, default=2,
                   help="Minimum abundance threshold for the output k-mers (def. 2)")
    p.add_argument("-t", "--threads", type=int, default=3,
                   help="Number of working threads (def. 3; sizes host prefetch)")
    p.add_argument("-o", "--output-file", default="",
                   help="Output file where the k-mer counts will be stored")
    p.add_argument("-b", "--use-bfilter", action="store_true",
                   help="Use bloom filters to discard unique k-mers")
    p.add_argument("-f", "--bfilter-fpr", type=float, default=0.01,
                   help="Bloom filter false positive rate (def. 0.01)")
    p.add_argument("-s", "--hash-tab-size", type=int, default=None, help="Hash table size")
    p.add_argument("-u", "--unq-kmers", type=int, default=None,
                   help="Estimated number of unique k-mers")
    p.add_argument("--devices", type=int, default=0,
                   help="Shard the table over this many devices (0 = single device)")
    p.add_argument("--backend", choices=("sort", "table"), default="sort",
                   help="Counting backend: 'sort' (flagship sort/segment-reduce "
                        "pipeline; -b runs the two-pass Bloom "
                        "prefilter on it) or 'table' (EXPERIMENTAL batched "
                        "open-addressing probe table — a correctness oracle, "
                        "orders of magnitude slower than 'sort') (def. sort)")
    p.add_argument("--pipeline", choices=("auto", "classic", "skm"),
                   default="auto",
                   help="Sort-backend counting pipeline: 'skm' deduplicates "
                        "minimizer runs (super-k-mers) before sorting "
                        "(faster; requires k >= 16); 'classic' sorts one "
                        "row per window; 'auto' picks skm when eligible "
                        "(def. auto)")
    p.add_argument("-q", "--quiet", action="store_true", help="Suppress the settings banner")
    p.add_argument("--query", action="store_true",
                   help="After counting, read k-mers from stdin and print their "
                        "counts (0 = absent, -1 = malformed) — the reference's "
                        "interactive point-lookup loop")
    p.add_argument("--histo", default="",
                   help="Also write a k-mer abundance spectrum (count -> #distinct "
                        "k-mers, one 'COUNT N' line each) to this file")
    return p


def validate(args) -> str:
    if args.KLEN < 2:
        return "KLEN must be >= 2"
    if (args.hash_tab_size is None) == (args.unq_kmers is None):
        return "exactly one of -s/--hash-tab-size or -u/--unq-kmers is required"
    if args.use_bfilter and args.unq_kmers is None:
        return "-b/--use-bfilter requires -u/--unq-kmers"
    if args.unq_kmers is not None and not args.use_bfilter:
        return "-u/--unq-kmers requires -b/--use-bfilter"
    if not (3 <= args.threads <= 64):
        return "-t/--threads must be in [3, 64]"
    if not (0.001 <= args.bfilter_fpr <= 0.999):
        return "-f/--bfilter-fpr must be in [0.001, 0.999]"
    # reject silently-ignored flag combinations instead of overriding by
    # dispatch order (the sharded path has no table backend or Bloom pass)
    if args.devices > 1 and args.backend == "table":
        return "--backend table does not support --devices; use the sort backend"
    if args.devices > 1 and args.use_bfilter:
        return "-b/--use-bfilter does not support --devices yet"
    if args.pipeline == "auto":
        # skm when eligible: k >= 16, sort backend
        args.pipeline = "skm" if (args.KLEN >= 16
                                  and args.backend == "sort") else "classic"
    if args.pipeline == "skm":
        if args.KLEN < 16:
            return "--pipeline skm requires KLEN >= 16"
        if args.backend != "sort":
            return "--pipeline skm supports only the sort backend"
    if not os.path.isfile(args.INPUT):
        return f"input file {args.INPUT} does not exist"
    return ""


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    err = validate(args)
    if err:
        print(f"error: {err}", file=sys.stderr)
        return 1

    # imports deferred so `--help` stays fast
    import jax

    from .utils.compile_cache import enable_compile_cache

    # persistent compile cache: the fused superstep is one large XLA
    # program per (k, shape); caching it across runs saves the first
    # compile (the reference has no compile phase)
    enable_compile_cache()

    from .io.reader import FormatError, sniff_format
    from .models.counter import CounterConfig, KmerCounter

    try:
        fmt, gz = sniff_format(args.INPUT)
    except (FormatError, OSError) as e:
        print(f"Input file {args.INPUT} is ill-formed: {e}", file=sys.stderr)
        return 1
    out = args.output_file
    if not out:
        stem = os.path.splitext(os.path.basename(args.INPUT))[0]
        out = stem + ".kaarme_counts"

    if not args.quiet:
        print("Running settings:")
        print(f"  input file:               {os.path.basename(args.INPUT)}")
        fmt_name = {"fasta": "FASTA", "fastq": "FASTQ"}.get(fmt, "ONE-STR-PER-LINE")
        print(f"  input format:             {fmt_name}")
        print(f"  gzip compressed:          {'yes' if gz else 'no'}")
        print(f"  k-mer length:             {args.KLEN}")
        print(f"  min. abundance threshold: {args.min_k_abu}")
        print(f"  hash table type:          {'plain' if args.hash_table_type == 0 else 'kaarme'}")
        print(f"  using bloom filters:      {'yes' if args.use_bfilter else 'no'}")
        if args.use_bfilter:
            print(f"    est. unique k-mers:     {args.unq_kmers}")
            print(f"    false positive rate:    {args.bfilter_fpr}")
        else:
            print(f"    est. hash table size:   {args.hash_tab_size}")
        print(f"  output file:              {out}")

    t0 = time.perf_counter()
    if args.use_bfilter and args.backend == "table":
        # full two-pass Bloom machinery (BF1/BF2, squeeze, filtered pass 2)
        from .models.bloom_counter import BloomCounterConfig, bloom_count_file

        cfg = BloomCounterConfig(
            k=args.KLEN,
            expected_unique=args.unq_kmers,
            fpr=args.bfilter_fpr,
            mode=args.hash_table_type,
            min_abundance=args.min_k_abu,
        )
        counter = bloom_count_file(cfg, args.INPUT, prefetch=max(1, args.threads - 2))
    elif args.use_bfilter:
        # sort/skm backends: literal two-pass Bloom mechanism (pass 1
        # fills BF1/BF2, squeeze, pass 2 admits only BF2 hits —
        # reference main.cpp:395-510).  Classic pipeline filters windows
        # before the merge; the skm pipeline streams runs unfiltered and
        # applies the BF2 gate at finalize expansion, where windows
        # materialize (a run row packs up to LMAX windows).
        est = max(os.path.getsize(args.INPUT), 1)
        blog2 = max(12, min(24, (est - 1).bit_length()))
        if args.pipeline == "skm":
            from .models.bloom_counter import bloom_skm_count_file
            from .models.skm_counter import SkmCounterConfig

            cfg = SkmCounterConfig(
                k=args.KLEN,
                mode=args.hash_table_type,
                min_abundance=args.min_k_abu,
                batch_windows=1 << blog2,
                rows=1 << (blog2 // 2),
                prefix_cap=1 << max(12, min(22, blog2)),
            )
            counter = bloom_skm_count_file(
                cfg, args.unq_kmers, args.bfilter_fpr, args.INPUT,
                prefetch=max(1, args.threads - 2))
        else:
            from .models.bloom_counter import bloom_sort_count_file
            from .models.sort_counter import SortCounterConfig

            cfg = SortCounterConfig(
                k=args.KLEN,
                mode=args.hash_table_type,
                min_abundance=args.min_k_abu,
                batch_windows=1 << blog2,
                rows=1 << (blog2 // 2),
                prefix_cap=1 << max(12, min(22, blog2)),
            )
            counter = bloom_sort_count_file(
                cfg, args.unq_kmers, args.bfilter_fpr, args.INPUT,
                prefetch=max(1, args.threads - 2))
    elif args.devices > 1:
        from .parallel.sharded import make_mesh
        from .parallel.sharded_sort import ShardedSortConfig, ShardedSortCounter

        est = max(os.path.getsize(args.INPUT), 1)
        blog2 = max(10, min(22, (est // args.devices - 1).bit_length()))
        # -s sizes the distinct store like the reference's table size;
        # prefix_cap is PER-DEVICE, so split it (growth covers the rest)
        cap = 1 << max(10, min(20, blog2))
        if args.hash_tab_size:
            from .ops.sortcount import next_store_size

            cap = max(cap, next_store_size(
                -(-args.hash_tab_size // args.devices)))
        kw = dict(
            k=args.KLEN,
            mode=args.hash_table_type,
            min_abundance=args.min_k_abu,
            batch_windows=1 << blog2,
            rows=1 << (blog2 // 2),
            prefix_cap=cap,
        )
        if args.pipeline == "skm":
            # blog2 >= 10 keeps batch_windows a multiple of skm.TILE
            from .parallel.sharded_skm import (ShardedSkmConfig,
                                               ShardedSkmCounter)

            counter = ShardedSkmCounter(ShardedSkmConfig(**kw),
                                        make_mesh(args.devices))
        else:
            counter = ShardedSortCounter(ShardedSortConfig(**kw),
                                         make_mesh(args.devices))
        counter.count_file(args.INPUT)
    elif args.backend == "sort":
        from .models.sort_counter import SortCounterConfig, SortKmerCounter

        # size the device batch from the input so small inputs do not pay
        # 16M-window compiles (file bytes upper-bound the window count)
        est = max(os.path.getsize(args.INPUT), 1)
        blog2 = max(12, min(24, (est - 1).bit_length()))
        kw = dict(
            k=args.KLEN,
            min_slots=args.hash_tab_size,
            mode=args.hash_table_type,
            min_abundance=args.min_k_abu,
            batch_windows=1 << blog2,
            rows=1 << (blog2 // 2),
            prefix_cap=1 << max(12, min(22, blog2)),
        )
        if blog2 >= 24 and jax.default_backend() == "gpu":
            # large inputs on the GPU: bigger skm supersteps
            # amortize the per-superstep prefix re-sort and dispatch
            # overhead, and one-superstep transfer groups keep each copy
            # small enough to ride ahead of the compute it overlaps
            # (classic keeps superbatch 4: its merge sorts the FULL
            # window mass; the skm merge sorts ~n/14 run rows).  Untuned
            # defaults on the GPU — ROADMAP S7 re-derives them.
            kw.update(transfer_group=1)
            if args.pipeline == "skm":
                kw.update(superbatch_batches=16)
        if args.pipeline == "skm":
            from .models.skm_counter import SkmCounter, SkmCounterConfig

            counter = SkmCounter(SkmCounterConfig(**kw))
        else:
            counter = SortKmerCounter(SortCounterConfig(**kw))
        counter.count_file(args.INPUT, prefetch=max(1, args.threads - 2))
    else:
        cfg = CounterConfig(
            k=args.KLEN,
            min_slots=args.hash_tab_size,
            mode=args.hash_table_type,
            min_abundance=args.min_k_abu,
        )
        counter = KmerCounter(cfg)
        counter.count_file(args.INPUT, prefetch=max(1, args.threads - 2))
    build_s = time.perf_counter() - t0

    n = counter.write_output(out)
    if args.histo:
        import numpy as np

        _, cn = counter.dump()
        cn = counter._clip(cn)
        spec = np.bincount(cn[cn > 0])
        with open(args.histo, "w") as f:
            for c in np.nonzero(spec)[0]:
                if c > 0:
                    f.write(f"{c} {spec[c]}\n")
    used, cap = counter.occupancy()
    if not args.quiet:
        print(f"Time used for hash table construction: {build_s * 1e6:.0f} microseconds")
        print(f"Time used for writing k-mers: {counter.stats.get('write_seconds', 0.0) * 1e6:.0f} microseconds")
        print(f"Hash table slots in use: {used}/{cap}")
        print(f"K-mers written: {n}")

    if args.query:
        # point-lookup loop (reference: source/program_runs.cpp:377-433,
        # table find API source/kmer_hash_table.cpp:2675-2727).
        # Dump the table ONCE and binary-search per line — find() would
        # re-fetch the whole store per query.
        import numpy as np

        from .ops import sortcount as _sc
        from .utils import codec as _codec

        tk, cn = counter.dump()
        if tk.shape[0]:
            # sort once (the table backend dumps slot order) so each query
            # is a binary search instead of a full-store fetch
            order = np.lexsort(
                tuple(tk[:, i] for i in range(tk.shape[1] - 1, -1, -1)))
            tk, cn = tk[order], cn[order]
        for line in sys.stdin:
            qk = line.strip()
            if not qk:
                continue
            if len(qk) != args.KLEN or any(ch not in "ACGTacgt" for ch in qk):
                print(-1)
                continue
            q = _codec.pack_kmer(_codec.canonical(qk.upper()))[None, :]
            c = _sc.lookup_sorted(tk, cn, q.astype(np.uint32))[0]
            print(int(counter._clip(np.asarray([c], np.int64))[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
