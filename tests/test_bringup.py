"""The plain-XLA device path and the entry points around it: removed
kernel options are rejected, the compile cache lands where it should,
meshes never silently fall back to the CPU, the packing matmul keeps
full f32 precision, and chip_smoke.py's pieces work (its device check
refuses the CPU)."""

import gzip
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import chip_smoke
from kaarme_tpu import cli
from kaarme_tpu.models.skm_counter import SkmCounter, SkmCounterConfig
from kaarme_tpu.models.sort_counter import SortCounterConfig
from kaarme_tpu.ops import skm
from kaarme_tpu.parallel.sharded import make_mesh
from kaarme_tpu.parallel.sharded_sort import ShardedSortConfig
from kaarme_tpu.utils import codec, compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- removed kernel options --------------------------------------------------

@pytest.mark.parametrize("cls,field,value", [
    (SortCounterConfig, "compactor", "merge"),
    (SkmCounterConfig, "segpack", "dense"),
    (SkmCounterConfig, "skm_cap_frac", 8),
])
def test_removed_config_fields_rejected(cls, field, value):
    with pytest.raises(TypeError):
        cls(k=31, **{field: value})


@pytest.mark.parametrize("mode", ["auto", "legacy", "merge", "interpret"])
def test_removed_winkeys_modes_rejected(mode):
    with pytest.raises(ValueError):
        SortCounterConfig(k=31, winkeys=mode)
    with pytest.raises(ValueError):
        ShardedSortConfig(k=31, winkeys=mode)


@pytest.mark.parametrize("flag", [["--compactor", "xla"],
                                  ["--segpack", "dense"]])
def test_removed_cli_options_rejected(tmp_path, flag):
    fa = tmp_path / "x.fa"
    fa.write_text(">r\nACGTACGTACGTACGTACGT\n")
    with pytest.raises(SystemExit) as e:
        cli.main([str(fa), "5", "-s", "100"] + flag)
    assert e.value.code == 2


def test_skm_superstep_has_no_kernel_switch():
    with pytest.raises(TypeError):
        skm.skm_superstep(None, None, None, k=31, n=512, S=96,
                          segpack="dense")


# -- compile cache -----------------------------------------------------------

@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_var_wins(monkeypatch, tmp_path, restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None   # left to JAX


def test_compile_cache_default_in_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# -- device mesh -------------------------------------------------------------

def test_make_mesh_raises_without_enough_devices():
    with pytest.raises(ValueError, match="need 16 devices"):
        make_mesh(16)


def test_make_mesh_rejects_non_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        make_mesh(3)


def test_make_mesh_on_requested_platform():
    mesh = make_mesh(4, platform="cpu")
    assert mesh.devices.size == 4
    assert {d.platform for d in mesh.devices.flat} == {"cpu"}


# -- packing precision -------------------------------------------------------

def test_pack_slots_matmul_is_highest_precision():
    """pack_slots' one-hot matmul sums u16-ranged f32 terms; it is exact
    only at full f32, so the lowered dot must request HIGHEST."""
    n, k = 1024, 31
    ncols = skm.store_words(k)
    b = jnp.zeros((n,), jnp.int32)
    cols = tuple(jnp.zeros((n,), jnp.uint32) for _ in range(ncols))
    text = jax.jit(lambda b, c: skm.pack_slots(b, c, n, 96, k)).lower(
        b, cols).as_text()
    dots = [ln for ln in text.splitlines() if "dot_general" in ln]
    assert dots
    assert all("HIGHEST" in ln for ln in dots)


# -- chip_smoke.py -----------------------------------------------------------

def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    r = _run_smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_without_the_package(tmp_path):
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    r = _run_smoke(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_sample_reads_shape_and_n_runs():
    rng = np.random.default_rng(1)
    genome = chip_smoke.make_genome(rng, 20000)
    reads = chip_smoke.sample_reads(rng, genome, 30, n_frac=0.05)
    assert reads.shape == (20000 * 30 // 150, 150)
    has_n = (reads == 4).any(axis=1)
    assert 0.02 < has_n.mean() < 0.1
    assert set(np.unique(reads)) <= {0, 1, 2, 3, 4}


def test_sample_reads_cover_both_strands():
    """Every N-free read is a substring of the genome or of its reverse
    complement, and both occur."""
    rng = np.random.default_rng(2)
    genome = chip_smoke.make_genome(rng, 3000)
    reads = chip_smoke.sample_reads(rng, genome, 5, n_frac=0.0)
    fwd = codec.decode_codes(genome)
    rev = codec.revcomp(fwd)
    strands = [(codec.decode_codes(r) in fwd, codec.decode_codes(r) in rev)
               for r in reads]
    assert all(a or b for a, b in strands)
    assert any(a for a, _ in strands) and any(b for _, b in strands)


def test_write_fasta_round_trips(tmp_path):
    rng = np.random.default_rng(3)
    reads = chip_smoke.sample_reads(
        rng, chip_smoke.make_genome(rng, 2000), 10, n_frac=0.1)
    path = tmp_path / "r.fa"
    chip_smoke.write_fasta(str(path), reads)
    text = path.read_bytes()
    assert max(len(ln) for ln in text.split(b"\n")) <= 60
    assert text.count(b">") == reads.shape[0]
    codes, _ = codec.encode_fasta(text)
    exp = chip_smoke.reads_to_codes(reads)
    assert codec.golden_count(codes, 21) == codec.golden_count(exp, 21)


def test_write_fastq_gz_round_trips(tmp_path):
    rng = np.random.default_rng(4)
    reads = chip_smoke.sample_reads(
        rng, chip_smoke.make_genome(rng, 2000), 10, n_frac=0.1)
    path = tmp_path / "r.fq.gz"
    chip_smoke.write_fastq_gz(str(path), reads)
    lines = gzip.decompress(path.read_bytes()).split(b"\n")
    seqs = lines[1::4][: reads.shape[0]]
    assert [s.decode() for s in seqs] == [codec.decode_codes(r) for r in reads]


@pytest.mark.parametrize("mode,min_abu,exp", [
    (2, 2, b"AAA 16383\nCCC 2\n"),           # 14-bit saturation
    (0, 2, b"CCC 2\nGGG 3\n"),               # uint16 wrap: 65537 -> 1
    (0, 1, b"AAA 1\nCCC 2\nGGG 3\nTTT 1\n"),
])
def test_expected_output_clips_and_filters(mode, min_abu, exp):
    golden = {"GGG": 65539, "CCC": 2, "AAA": 65537, "TTT": 1}
    if mode == 2:
        golden = {"CCC": 2, "AAA": 20000, "TTT": 1}
    assert chip_smoke.expected_output(golden, mode, min_abu) == exp


def test_compare_output_finds_a_changed_count(tmp_path):
    exp = chip_smoke.expected_output({"AAC": 3, "ACG": 2}, 2, 2)
    out = tmp_path / "o"
    out.write_bytes(exp)
    assert chip_smoke.compare_output(str(out), exp) == ""
    out.write_bytes(exp.replace(b"ACG 2", b"ACG 4"))
    diff = chip_smoke.compare_output(str(out), exp)
    assert "1 unexpected" in diff and "1 missing" in diff


def test_chip_smoke_main_phase_tiny(tmp_path):
    """Phase 1 end to end through the CLI on a tiny genome (CPU)."""
    rng = np.random.default_rng(5)
    reads = chip_smoke.sample_reads(
        rng, chip_smoke.make_genome(rng, 8000), 30, n_frac=0.01)
    expected = chip_smoke.phase_main(str(tmp_path), reads)
    assert expected.count(b"\n") > 7000


# -- on the card -------------------------------------------------------------

@pytest.mark.gpu
def test_skm_counter_golden_on_gpu(gpu_device):
    """The default pipeline's compiled superstep and finalize on the
    GPU equal the golden oracle."""
    rng = np.random.default_rng(6)
    reads = chip_smoke.sample_reads(
        rng, chip_smoke.make_genome(rng, 50000), 10, n_frac=0.01)
    codes = chip_smoke.reads_to_codes(reads)
    with jax.default_device(gpu_device):
        c = SkmCounter(SkmCounterConfig(
            k=51, batch_windows=1 << 16, rows=1 << 9, superbatch_batches=2,
            prefix_cap=1 << 16, min_abundance=1)).count_codes(codes)
        assert c.as_dict() == codec.golden_count(codes, 51)
