"""Smoke test of the k-mer counter on one NVIDIA GPU.

Drives the command-line entry point in-process (``kaarme_tpu.cli.main``)
on the reference's own workload (k=51, ``-s 8000000``) scaled to
standard coverage: a 4.6 Mb E. coli-scale random genome sampled at 30x
in 150 bp reads, ~0.1% of them carrying a run of N.  Every input is
generated from ``--seed``; every output file is compared for exact
equality with the host oracle ``kaarme_tpu.utils.codec.golden_count``
(counts are integers, so no tolerance applies).

Phases (one process; only ``nvidia-smi`` runs as a child):
  0. device: requires a CUDA device and prints what it runs on;
  1. main path: default skm pipeline, kaarme mode, on a wrapped
     multi-record FASTA at 30x; a cold and a warm run;
  2. classic pipeline in mode 0 at k=31 and k=15 on gzipped FASTQ at 5x;
  3. Bloom prefilter (-b -u 4000000 -f 0.01) at k=51 on the 5x file.
With ``--four-cards`` only the sharded path runs: the phase-1 input
through ``--devices 4`` with the skm and the classic pipeline.

Usage:  python chip_smoke.py [--four-cards] [--seed N] [--workdir DIR]

The last line of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import sys
import tempfile
import time

import numpy as np

GENOME_BP = 4_600_000
READ_LEN = 150
N_READ_FRAC = 0.001        # share of reads that carry a run of N
FASTA_WIDTH = 60
KAARME_SATURATION = 16383  # 14-bit saturation of the kaarme table


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# Inputs (seeded)
# ---------------------------------------------------------------------------

def make_genome(rng, length: int) -> np.ndarray:
    return rng.integers(0, 4, size=length, dtype=np.int64).astype(np.uint8)


def sample_reads(rng, genome: np.ndarray, coverage: int,
                 read_len: int = READ_LEN,
                 n_frac: float = N_READ_FRAC) -> np.ndarray:
    """(n_reads, read_len) codes: reads from both strands at the given
    coverage; a share ``n_frac`` of them carries a run of 1-10 N (code
    4)."""
    n_reads = genome.shape[0] * coverage // read_len
    starts = rng.integers(0, genome.shape[0] - read_len + 1, size=n_reads)
    reads = genome[starts[:, None] + np.arange(read_len)[None, :]]
    rev = rng.random(n_reads) < 0.5
    reads[rev] = 3 - reads[rev, ::-1]
    with_n = np.flatnonzero(rng.random(n_reads) < n_frac)
    run = rng.integers(1, 11, size=with_n.shape[0])
    at = rng.integers(0, read_len - 10, size=with_n.shape[0])
    for r, a, ln in zip(with_n, at, run):
        reads[r, a:a + ln] = 4
    return reads


def reads_to_codes(reads: np.ndarray) -> np.ndarray:
    """The code stream the counter sees: reads separated by code 4."""
    stream = np.full((reads.shape[0], reads.shape[1] + 1), 4, np.uint8)
    stream[:, :-1] = reads
    return stream.reshape(-1)


def _letters(reads: np.ndarray) -> np.ndarray:
    return np.frombuffer(b"ACGTN", np.uint8)[reads]


def _headers(prefix: bytes, n: int) -> np.ndarray:
    return np.frombuffer(b"".join(prefix + b"r%09d\n" % i for i in range(n)),
                         np.uint8).reshape(n, -1)


def write_fasta(path: str, reads: np.ndarray,
                width: int = FASTA_WIDTH) -> None:
    """Multi-record FASTA, sequence lines wrapped at ``width``."""
    n, ln = reads.shape
    seq = _letters(reads)
    parts = [_headers(b">", n)]
    for lo in range(0, ln, width):
        parts.append(seq[:, lo:lo + width])
        parts.append(np.full((n, 1), ord("\n"), np.uint8))
    with open(path, "wb") as f:
        f.write(np.concatenate(parts, axis=1).tobytes())


def write_fastq_gz(path: str, reads: np.ndarray) -> None:
    n, ln = reads.shape
    nl = np.full((n, 1), ord("\n"), np.uint8)
    rec = np.concatenate([
        _headers(b"@", n), _letters(reads), nl,
        np.frombuffer(b"+\n", np.uint8)[None, :].repeat(n, 0),
        np.full((n, ln), ord("I"), np.uint8), nl], axis=1)
    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(rec.tobytes())


# ---------------------------------------------------------------------------
# Oracle and comparison
# ---------------------------------------------------------------------------

def expected_output(golden: dict, mode: int, min_abundance: int) -> bytes:
    """The CLI's output file for these true counts: ``KMER COUNT`` lines
    in sorted order, counts clipped as the table type does (uint16 wrap
    in mode 0, 14-bit saturation otherwise), then filtered."""
    lines = []
    for km, c in golden.items():
        c = c & 0xFFFF if mode == 0 else min(c, KAARME_SATURATION)
        if c >= min_abundance:
            lines.append(f"{km} {c}\n")
    lines.sort()
    return "".join(lines).encode()


def compare_output(path: str, expected: bytes) -> str:
    """'' when the file equals ``expected`` byte for byte, else a short
    description of the difference."""
    with open(path, "rb") as f:
        got = f.read()
    if got == expected:
        return ""
    g, e = set(got.splitlines()), set(expected.splitlines())
    return (f"{len(g)} lines vs {len(e)} expected; "
            f"{len(g - e)} unexpected (e.g. {sorted(g - e)[:3]}), "
            f"{len(e - g)} missing (e.g. {sorted(e - g)[:3]})")


def golden_for(codes: np.ndarray, k: int) -> dict:
    from kaarme_tpu.utils import codec

    t0 = time.perf_counter()
    golden = codec.golden_count(codes, k)
    log(f"  golden k={k}: {len(golden)} distinct in "
        f"{time.perf_counter() - t0:.1f}s")
    return golden


def run_cli(argv: list) -> float:
    """kaarme_tpu.cli.main(argv) in this process; wall seconds."""
    from kaarme_tpu import cli

    t0 = time.perf_counter()
    rc = cli.main(argv)
    dt = time.perf_counter() - t0
    if rc != 0:
        fail(f"cli.main({argv}) returned {rc}")
    return dt


def check_run(name: str, argv: list, out: str, expected: bytes) -> float:
    dt = run_cli(argv + ["-o", out, "-q"])
    diff = compare_output(out, expected)
    if diff:
        fail(f"{name}: output differs from golden: {diff}")
    n = expected.count(b"\n")
    log(f"  {name}: golden PASS ({n} k-mers), wall {dt:.2f}s")
    return dt


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device():
    import jax

    from kaarme_tpu.utils.device import card_name_and_power_limit, require_gpu

    dev = require_gpu()
    log("phase 0: device")
    for line in card_name_and_power_limit().splitlines():
        log(f"  nvidia-smi: {line.strip()}")
    log(f"  device_kind: {dev.device_kind}")
    log(f"  device count: {len(jax.devices())}")
    log(f"  jax: {jax.__version__}")

    from kaarme_tpu.io import fastio
    from kaarme_tpu.utils.compile_cache import enable_compile_cache

    log(f"  compile cache: {enable_compile_cache()}")
    log(f"  encoder: {'native' if fastio.get_lib() is not None else 'numpy'}")
    return dev


def _main_input(workdir: str, reads: np.ndarray, k: int):
    """The phase-1 FASTA, its CLI arguments and its expected output
    (kaarme mode, min abundance 2)."""
    fa = os.path.join(workdir, "reads30x.fa")
    write_fasta(fa, reads)
    log(f"  {reads.shape[0]} reads ({reads.size} bases), "
        f"FASTA {os.path.getsize(fa)} bytes")
    expected = expected_output(golden_for(reads_to_codes(reads), k), 2, 2)
    return [fa, str(k), "-s", "8000000", "-a", "2"], expected


def phase_main(workdir: str, reads: np.ndarray, k: int = 51) -> bytes:
    """Default skm pipeline, kaarme mode, through the CLI: cold then
    warm.  Returns the expected output."""
    log("phase 1: main path")
    argv, expected = _main_input(workdir, reads, k)
    cold = check_run("skm k=51 cold", argv,
                     os.path.join(workdir, "cold.out"), expected)
    warm = check_run("skm k=51 warm", argv,
                     os.path.join(workdir, "warm.out"), expected)
    log(f"  cold wall {cold:.2f}s, warm wall {warm:.2f}s")
    return expected


def phase_classic(workdir: str, reads: np.ndarray, ks=(31, 15)) -> str:
    """Classic pipeline, mode 0 (uint16 wrap), on gzipped FASTQ.
    Returns the FASTQ path for the Bloom phase."""
    fq = os.path.join(workdir, "reads5x.fq.gz")
    write_fastq_gz(fq, reads)
    log(f"phase 2: classic pipeline, mode 0, {reads.shape[0]} reads, "
        f"FASTQ.gz {os.path.getsize(fq)} bytes")
    codes = reads_to_codes(reads)
    for k in ks:
        expected = expected_output(golden_for(codes, k), 0, 2)
        check_run(f"classic -m 0 k={k}",
                  [fq, str(k), "--pipeline", "classic", "-m", "0",
                   "-s", "8000000", "-a", "2"],
                  os.path.join(workdir, f"classic{k}.out"), expected)
    return fq


def phase_bloom(workdir: str, fq: str, reads: np.ndarray,
                k: int = 51) -> None:
    log("phase 3: Bloom prefilter")
    expected = expected_output(golden_for(reads_to_codes(reads), k), 2, 2)
    check_run(f"bloom k={k}",
              [fq, str(k), "-b", "-u", "4000000", "-f", "0.01", "-a", "2"],
              os.path.join(workdir, "bloom.out"), expected)


def phase_four_cards(workdir: str, reads: np.ndarray, k: int = 51) -> None:
    import jax

    devs = jax.devices()
    if len(devs) < 4:
        fail(f"--four-cards needs 4 devices, found {len(devs)}")
    log("phase 4: four cards")
    argv, expected = _main_input(workdir, reads, k)
    argv += ["--devices", "4"]
    check_run("sharded skm k=51", argv,
              os.path.join(workdir, "sharded_skm.out"), expected)
    check_run("sharded classic k=51", argv + ["--pipeline", "classic"],
              os.path.join(workdir, "sharded_classic.out"), expected)
    peaks = [d.memory_stats()["peak_bytes_in_use"] for d in devs[:4]]
    log(f"  peak_bytes_in_use per device: {peaks}")
    if min(peaks) <= 0:
        fail("a device shows no memory use: the work did not spread")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-device sharded phase")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=None,
                    help="directory for the generated inputs and outputs "
                         "(default: a temporary directory, removed after)")
    args = ap.parse_args(argv)

    import jax

    dev = phase_device()
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    genome = make_genome(rng, GENOME_BP)
    reads30 = sample_reads(rng, genome, 30)
    with tempfile.TemporaryDirectory(dir=args.workdir) as wd:
        if args.four_cards:
            phase_four_cards(wd, reads30)
        else:
            phase_main(wd, reads30)
            peak = dev.memory_stats()["peak_bytes_in_use"]
            log(f"  peak_bytes_in_use: {peak}")
            del reads30
            reads5 = sample_reads(rng, genome, 5)
            fq = phase_classic(wd, reads5)
            phase_bloom(wd, fq, reads5)
    log(f"all phases passed in {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
