import numpy as np

from kaarme_tpu import cli
from kaarme_tpu.io import reader as io_reader
from kaarme_tpu.utils import codec, compare


def _write_fasta(tmp_path, seed=0, n=600):
    rng = np.random.default_rng(seed)
    seq = "".join("ACGT"[c] for c in rng.integers(0, 4, size=n))
    p = tmp_path / "sample.fasta"
    p.write_text(">r1\n" + "\n".join(seq[i:i + 70] for i in range(0, n, 70)) + "\n")
    return p


def test_cli_end_to_end(tmp_path, monkeypatch, capsys):
    p = _write_fasta(tmp_path)
    monkeypatch.chdir(tmp_path)
    rc = cli.main([str(p), "9", "-s", "4096", "-a", "1", "-q"])
    assert rc == 0
    out = tmp_path / "sample.kaarme_counts"
    assert out.exists()
    golden = codec.golden_count(io_reader.read_codes(str(p)), 9)
    gold = tmp_path / "gold.txt"
    gold.write_text("".join(f"{s} {c}\n" for s, c in sorted(golden.items())))
    eq, diffs = compare.compare_count_files(str(out), str(gold))
    assert eq, diffs


def test_cli_validation_errors(tmp_path, capsys):
    p = _write_fasta(tmp_path)
    # both -s and -u
    assert cli.main([str(p), "9", "-s", "100", "-u", "100", "-b"]) == 1
    # neither
    assert cli.main([str(p), "9"]) == 1
    # -u without -b
    assert cli.main([str(p), "9", "-u", "100"]) == 1
    # -b without -u
    assert cli.main([str(p), "9", "-s", "100", "-b"]) == 1
    # bad threads
    assert cli.main([str(p), "9", "-s", "100", "-t", "2"]) == 1
    # missing file
    assert cli.main([str(tmp_path / "nope.fa"), "9", "-s", "100"]) == 1


def test_cli_output_option_and_banner(tmp_path, capsys):
    p = _write_fasta(tmp_path, seed=1)
    out = tmp_path / "custom.out"
    rc = cli.main([str(p), "9", "-s", "4096", "-o", str(out)])
    assert rc == 0
    captured = capsys.readouterr().out
    assert "Running settings:" in captured
    assert "FASTA" in captured
    assert out.exists()


def test_cli_devices_sharded(tmp_path, monkeypatch):
    """--devices routes through the sharded sort counter (virtual mesh)."""
    p = _write_fasta(tmp_path, seed=3, n=2000)
    out = tmp_path / "sharded.out"
    rc = cli.main([str(p), "9", "-s", "4096", "-a", "1", "-q",
                   "--devices", "8", "-o", str(out)])
    assert rc == 0
    golden = codec.golden_count(io_reader.read_codes(str(p)), 9)
    got = {ln.split()[0]: int(ln.split()[1]) for ln in out.read_text().splitlines()}
    assert got == golden


def test_cli_histo(tmp_path):
    p = _write_fasta(tmp_path, seed=4, n=1500)
    out = tmp_path / "h.out"
    histo = tmp_path / "h.histo"
    rc = cli.main([str(p), "7", "-s", "4096", "-a", "1", "-q",
                   "-o", str(out), "--histo", str(histo)])
    assert rc == 0
    golden = codec.golden_count(io_reader.read_codes(str(p)), 7)
    import collections
    spec = collections.Counter(golden.values())
    got = {int(a): int(b) for a, b in
           (ln.split() for ln in histo.read_text().splitlines())}
    assert got == dict(spec)


def test_cli_bloom_sort_backend_matches_table(tmp_path):
    """-b on the default sort backend: same output contract as the full
    two-pass Bloom machinery (singletons never reported)."""
    p = _write_fasta(tmp_path, seed=5, n=3000)
    a = tmp_path / "a.out"
    b = tmp_path / "b.out"
    assert cli.main([str(p), "9", "-b", "-u", "2000", "-q", "-o", str(a)]) == 0
    assert cli.main([str(p), "9", "-b", "-u", "2000", "-q", "-o", str(b),
                     "--backend", "table"]) == 0
    eq, diffs = compare.compare_count_files(str(a), str(b))
    assert eq, diffs
    golden = codec.golden_count(io_reader.read_codes(str(p)), 9)
    want = {s: c for s, c in golden.items() if c >= 2}
    got = {ln.split()[0]: int(ln.split()[1]) for ln in a.read_text().splitlines()}
    assert got == want


def test_cli_skm_pipeline_golden(tmp_path):
    """--pipeline skm end-to-end through the CLI: byte-identical output
    to the classic pipeline and to the golden oracle."""
    rng = np.random.default_rng(11)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, size=800))
    reads = []
    for i in range(120):
        s = int(rng.integers(0, 700))
        reads.append(genome[s: s + 90])
    p = tmp_path / "reads.txt"   # plain one-read-per-line input
    p.write_text("\n".join(reads) + "\n")
    a = tmp_path / "skm.out"
    b = tmp_path / "classic.out"
    assert cli.main([str(p), "31", "-s", "4096", "-a", "1", "-q",
                     "--pipeline", "skm", "-o", str(a)]) == 0
    assert cli.main([str(p), "31", "-s", "4096", "-a", "1", "-q",
                     "-o", str(b)]) == 0
    eq, diffs = compare.compare_count_files(str(a), str(b))
    assert eq, diffs
    golden = codec.golden_count(io_reader.read_codes(str(p)), 31)
    got = {ln.split()[0]: int(ln.split()[1])
           for ln in a.read_text().splitlines()}
    assert got == golden


def test_cli_skm_validation(tmp_path):
    p = _write_fasta(tmp_path, seed=7)
    # skm requires k >= 16
    assert cli.main([str(p), "9", "-s", "4096", "--pipeline", "skm"]) == 1
    # skm composes only with the single-device sort backend (for now)
    assert cli.main([str(p), "31", "-s", "4096", "--pipeline", "skm",
                     "--backend", "table"]) == 1


def test_cli_skm_devices_sharded(tmp_path):
    """--pipeline skm --devices N routes through the sharded skm
    counter (expand-then-exchange finalize on the virtual mesh)."""
    p = _write_fasta(tmp_path, seed=9, n=3000)
    out = tmp_path / "skm_sharded.out"
    rc = cli.main([str(p), "21", "-s", "4096", "-a", "1", "-q",
                   "--pipeline", "skm", "--devices", "8", "-o", str(out)])
    assert rc == 0
    golden = codec.golden_count(io_reader.read_codes(str(p)), 21)
    got = {ln.split()[0]: int(ln.split()[1])
           for ln in out.read_text().splitlines()}
    assert got == golden
