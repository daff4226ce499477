"""Super-k-mer pipeline (ops/skm.py): segmentation/pack parity vs the
NumPy mirror, and end-to-end golden equality of superstep + finalize."""

import numpy as np
import jax.numpy as jnp
import pytest

from kaarme_tpu.ops import skm, sortcount
from kaarme_tpu.utils import codec


def _pk_inval(codes_u8, n, k):
    """(padded packed words, invalid vector) as skm_superstep builds."""
    stream = np.asarray(codes_u8, np.uint8)[: n + k - 1]
    packed, _ = sortcount.pack_stream_np(stream)
    Wc = skm.content_words(k)
    need = (n + 16 * (Wc - 1)) // 16 + 2
    pk = np.zeros(max(need, packed.shape[0]), np.uint32)
    pk[: packed.shape[0]] = packed
    inval = (stream >= 4).astype(np.int32)
    return jnp.asarray(pk), jnp.asarray(inval)


def _make_stream(rng, n_codes, read_len):
    reads = rng.integers(0, 4, size=n_codes, dtype=np.int64).astype(np.uint8)
    stream = reads.copy()
    stream[read_len::read_len + 1] = 4  # separators
    return stream


@pytest.mark.parametrize("k", [31, 51])
def test_run_rows_match_numpy(k):
    rng = np.random.default_rng(11)
    n = 1024
    # low-entropy genome slice repeated -> real duplicate runs
    genome = rng.integers(0, 4, size=400, dtype=np.int64).astype(np.uint8)
    parts = []
    while sum(p.shape[0] for p in parts) < n + k - 1 + 8:
        s = int(rng.integers(0, 300))
        ln = int(rng.integers(k + 5, 100))
        parts.append(genome[s: s + ln])
        parts.append(np.full(1, 4, np.uint8))
    codes = np.concatenate(parts)

    pk, inval = _pk_inval(codes, n, k)
    b, cols = skm.run_rows(pk, inval, k, n)
    slotted, maxruns = skm.pack_slots(b, cols, n, 96, k)
    assert int(maxruns) <= 96

    got = {}
    rows = np.stack([np.asarray(c) for c in slotted], axis=1)
    for r in rows:
        if (r == 0xFFFFFFFF).all():
            continue
        key = tuple(int(x) for x in r[:-1]) + (int(r[-1]) & ~((1 << skm.EBITS) - 1),)
        got[key] = got.get(key, 0) + int(r[-1] & ((1 << skm.EBITS) - 1))
    exp = skm.run_rows_np(codes, k, n)
    assert got == exp


@pytest.mark.parametrize("k", [31, 51])
def test_superstep_and_finalize_golden(k):
    rng = np.random.default_rng(5)
    n = 2048
    # coverage-structured input: reads sampled from a small genome
    genome = rng.integers(0, 4, size=500, dtype=np.int64).astype(np.uint8)
    parts = []
    while sum(p.shape[0] for p in parts) < n + k - 1 + 8:
        s = int(rng.integers(0, 380))
        parts.append(genome[s: s + 120])
        parts.append(np.full(1, 4, np.uint8))
    codes = np.concatenate(parts)
    stream = codes[: n + k - 1]

    packed, maskw = sortcount.pack_stream_np(stream)
    Wp = skm.store_words(k)
    cap = 1 << 13
    prefix = sortcount.make_store(cap, Wp)
    store, ndv = skm.skm_superstep(
        jnp.asarray(packed), jnp.asarray(maskw), prefix,
        k=k, n=n, S=96, dense=True)
    nd, ndu, maxruns = (int(x) for x in np.asarray(ndv))
    assert maxruns <= 96 and nd <= cap

    run_np = tuple(np.asarray(c[:nd]) for c in store)
    keys, cnt = skm.finalize_counts(run_np, k)
    got = dict(zip(codec.unpack_kmers(keys, k), cnt.tolist()))
    golden = codec.golden_count(stream, k)
    assert got == golden
    # exactness invariant: total count == number of valid windows
    n_valid = sum(golden.values())
    assert int(cnt.sum()) == n_valid


def test_two_supersteps_merge():
    """Run-store merging across supersteps counts every window once."""
    k = 31
    rng = np.random.default_rng(9)
    n = 1024
    genome = rng.integers(0, 4, size=300, dtype=np.int64).astype(np.uint8)
    parts = []
    while sum(p.shape[0] for p in parts) < 2 * n + k - 1 + 8:
        s = int(rng.integers(0, 180))
        parts.append(genome[s: s + 110])
        parts.append(np.full(1, 4, np.uint8))
    stream = np.concatenate(parts)[: 2 * n + k - 1]

    Wp = skm.store_words(k)
    prefix = sortcount.make_store(1 << 13, Wp)
    for step in range(2):
        seg = stream[step * n: step * n + n + k - 1]
        packed, maskw = sortcount.pack_stream_np(seg)
        prefix, ndv = skm.skm_superstep(
            jnp.asarray(packed), jnp.asarray(maskw), prefix,
            k=k, n=n, S=96, dense=True)
    nd = int(np.asarray(ndv)[0])
    run_np = tuple(np.asarray(c[:nd]) for c in prefix)
    keys, cnt = skm.finalize_counts(run_np, k)
    got = dict(zip(codec.unpack_kmers(keys, k), cnt.tolist()))
    assert got == codec.golden_count(stream, k)


# ---------------------------------------------------------------------------
# Model layer
# ---------------------------------------------------------------------------

from kaarme_tpu.models.skm_counter import SkmCounter, SkmCounterConfig  # noqa: E402


def _coverage_stream(rng, glen, n_reads, read_len):
    genome = rng.integers(0, 4, size=glen, dtype=np.int64).astype(np.uint8)
    parts = []
    for _ in range(n_reads):
        s = int(rng.integers(0, glen - read_len))
        parts.append(genome[s: s + read_len])
        parts.append(np.full(1, 4, np.uint8))
    return np.concatenate(parts)


@pytest.mark.parametrize("k", [31, 51])
def test_skm_counter_golden(k):
    rng = np.random.default_rng(3)
    codes = _coverage_stream(rng, 800, 60, 120)
    cfg = SkmCounterConfig(k=k, batch_windows=512, rows=512,
                           superbatch_batches=2, prefix_cap=1 << 13,
                           min_abundance=1)
    c = SkmCounter(cfg)
    # odd-sized chunks exercise the buffer cursor
    i = 0
    for sz in (777, 1, 3000, 41, 10**9):
        c.add_codes(codes[i: i + sz])
        i += sz
    c.finish()
    assert c.as_dict() == codec.golden_count(codes, k)


def test_skm_slot_overflow_replay():
    """A tiny slot budget forces max_tile_runs > S; the driver must bump
    the ladder, replay, and still produce exact counts."""
    rng = np.random.default_rng(8)
    codes = _coverage_stream(rng, 600, 40, 90)
    cfg = SkmCounterConfig(k=31, batch_windows=512, rows=512,
                           superbatch_batches=2, prefix_cap=1 << 13,
                           min_abundance=1, skm_slots=8)
    c = SkmCounter(cfg).count_codes(codes)
    assert c.stats["slot_grow_events"] >= 1
    assert c.as_dict() == codec.golden_count(codes, 31)


def test_skm_store_growth_replay():
    rng = np.random.default_rng(2)
    codes = _coverage_stream(rng, 3000, 40, 130)
    cfg = SkmCounterConfig(k=31, batch_windows=512, rows=512,
                           superbatch_batches=1, prefix_cap=1 << 12,
                           min_abundance=1)
    # ladder floor is 1<<12: force growth by keeping the cap at the floor
    c = SkmCounter(cfg).count_codes(codes)
    assert c.as_dict() == codec.golden_count(codes, 31)


def test_skm_save_load_resume(tmp_path):
    rng = np.random.default_rng(4)
    codes = _coverage_stream(rng, 700, 50, 100)
    cfg = dict(k=31, batch_windows=512, rows=512, superbatch_batches=1,
               prefix_cap=1 << 13, min_abundance=1)
    c = SkmCounter(SkmCounterConfig(**cfg))
    c.add_codes(codes[:2000])
    p = str(tmp_path / "skm.npz")
    c.save(p)
    c2 = SkmCounter.load(p, SkmCounterConfig(**cfg))
    c2.add_codes(codes[2000:])
    c2.finish()
    assert c2.as_dict() == codec.golden_count(codes, 31)


def test_skm_find_and_clipping():
    rng = np.random.default_rng(6)
    codes = _coverage_stream(rng, 300, 80, 80)
    cfg = SkmCounterConfig(k=31, batch_windows=512, rows=512,
                           superbatch_batches=1, prefix_cap=1 << 13,
                           min_abundance=1)
    c = SkmCounter(cfg).count_codes(codes)
    golden = codec.golden_count(codes, 31)
    some = list(golden)[:5]
    assert c.find(some) == [golden[s] for s in some]
    assert c.find(["N" * 31]) == [-1]


def test_skm_cold_start_overflow_replay_terminates():
    """A first superstep whose distinct runs exceed the cold-start prefix
    guess (sizing active: prefix_cap > 2^12) overflows; the replay must
    keep the grown size instead of slicing back to the guess."""
    rng = np.random.default_rng(10)
    codes = rng.integers(0, 4, size=1 << 18, dtype=np.int64).astype(np.uint8)
    cfg = SkmCounterConfig(k=31, batch_windows=1 << 18, rows=1 << 9,
                           superbatch_batches=1, prefix_cap=1 << 20,
                           min_abundance=1)
    c = SkmCounter(cfg).count_codes(codes)
    assert c.n_distinct > (1 << 14)        # above the cold-start guess
    assert c.as_dict() == codec.golden_count(codes, 31)
