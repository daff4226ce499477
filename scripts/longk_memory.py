"""Long-k closure: k=101/201 at ecoli-ish
scale — golden-oracle equality through both pipelines plus the
measured bytes/distinct-kmer of the classic columnar store vs the skm
run store vs the reference's ~17 B/kmer (kmer.hpp:103-149 slot word +
secondary array at 0.5 load; DESIGN.md section 7b).

    python scripts/longk_memory.py [--genome-mb 1.0 --coverage 8]

Writes the results to --out.
"""

import argparse
import json
import os
import time

import numpy as np

import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-mb", type=float, default=1.0)
    ap.add_argument("--coverage", type=int, default=8)
    ap.add_argument("--read-len", type=int, default=300)
    ap.add_argument("--ks", type=int, nargs="+", default=[101, 201])
    ap.add_argument("--golden", action="store_true",
                    help="also diff against the NumPy golden oracle "
                         "(slow at scale; always done at --genome-mb "
                         "<= 0.3)")
    ap.add_argument("--out", default="longk_memory.json")
    args = ap.parse_args()

    results = {}
    if os.path.exists(args.out):
        results = json.load(open(args.out))

    import jax

    from kaarme_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from bench import make_reads
    from kaarme_tpu.models.skm_counter import SkmCounter, SkmCounterConfig
    from kaarme_tpu.models.sort_counter import (SortCounterConfig,
                                                SortKmerCounter)
    from kaarme_tpu.ops import skm
    from kaarme_tpu.utils import codec

    codes = make_reads(args.genome_mb, args.coverage, args.read_len)
    do_golden = args.golden or args.genome_mb <= 0.3

    for k in args.ks:
        nwin = int((codes.shape[0] // (args.read_len + 1))
                   * (args.read_len - k + 1))
        common = dict(batch_windows=1 << 21, rows=1 << 10,
                      superbatch_batches=2, prefix_cap=1 << 21,
                      min_abundance=1)
        t0 = time.perf_counter()
        c1 = SortKmerCounter(SortCounterConfig(k=k, **common))
        c1.count_codes(codes)
        t1 = time.perf_counter() - t0
        nd = c1.n_distinct
        w = c1.cfg.words
        classic_bpd = 4 * (w + 1)
        print(f"k={k} classic: {t1:.2f}s {nwin/t1/1e6:.1f}M w/s "
              f"distinct={nd} store={classic_bpd} B/kmer", flush=True)

        t0 = time.perf_counter()
        c2 = SkmCounter(SkmCounterConfig(k=k, **common))
        c2.count_codes(codes)
        store, nd2 = c2.finalize_device()
        for col in store:
            np.asarray(col[:1])
        t2 = time.perf_counter() - t0
        runs = c2.n_distinct
        run_bpd = 4 * (skm.store_words(k) + 1) * runs / max(nd, 1)
        print(f"k={k} skm:     {t2:.2f}s {nwin/t2/1e6:.1f}M w/s "
              f"runs={runs} run-store={run_bpd:.1f} B/kmer "
              f"(ref ~17 B/kmer)", flush=True)

        tk1, cn1 = c1.dump()
        tk2, cn2 = c2.dump()
        eq = (tk1.shape == tk2.shape and np.array_equal(tk1, tk2)
              and np.array_equal(cn1, cn2))
        print(f"k={k} classic == skm: {eq}", flush=True)
        assert eq
        row = {
            "device": str(jax.devices()[0]),
            "workload": f"{args.genome_mb}MB x{args.coverage} "
                        f"rl{args.read_len}",
            "windows": nwin,
            "distinct_kmers": int(nd),
            "distinct_runs": int(runs),
            "classic_seconds": round(t1, 2),
            "classic_kmers_per_s": round(nwin / t1),
            "classic_store_B_per_kmer": classic_bpd,
            "skm_seconds": round(t2, 2),
            "skm_kmers_per_s": round(nwin / t2),
            "run_store_B_per_kmer": round(run_bpd, 1),
            "reference_B_per_kmer": "~17 (kmer.hpp:103-149 slot + "
                                    "secondary at 0.5 load)",
            "classic_equals_skm": bool(eq),
        }
        if do_golden:
            golden = codec.golden_count(codes, k)
            got = c1.as_dict()
            row["golden_equal"] = bool(got == golden)
            print(f"k={k} golden equality: {got == golden} "
                  f"({len(golden)} distinct)", flush=True)
            assert got == golden
        results[f"k{k}_{args.genome_mb}MB"] = row
        json.dump(results, open(args.out, "w"), indent=1)


if __name__ == "__main__":
    main()
