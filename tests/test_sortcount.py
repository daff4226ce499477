"""Sort-based counting backend: kernel units + end-to-end golden equality."""

import numpy as np
import pytest

from kaarme_tpu.io import fastio
from kaarme_tpu.models.sort_counter import SortCounterConfig, SortKmerCounter
from kaarme_tpu.ops import sortcount
from kaarme_tpu.utils import codec


def _random_stream(rng, n, p_sep=0.02):
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    sep = rng.random(n) < p_sep
    codes[sep] = 4
    return codes


def _counter(k, **kw):
    kw.setdefault("batch_windows", 1 << 12)
    kw.setdefault("rows", 1 << 6)
    kw.setdefault("prefix_cap", 1 << 13)
    kw.setdefault("min_abundance", 1)
    return SortKmerCounter(SortCounterConfig(k=k, **kw))


# -- packing -----------------------------------------------------------------

def test_pack_stream_native_matches_numpy():
    rng = np.random.default_rng(0)
    for n in (0, 1, 15, 16, 17, 31, 32, 33, 1000):
        codes = _random_stream(rng, n, p_sep=0.2)
        p_np, m_np = sortcount.pack_stream_np(codes)
        p_c, m_c = fastio.pack_stream(codes)
        np.testing.assert_array_equal(p_np, p_c)
        np.testing.assert_array_equal(m_np, m_c)


def test_unpack_roundtrip():
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    codes = _random_stream(rng, 777, p_sep=0.1)
    p, m = sortcount.pack_stream_np(codes)
    dev_codes, inval = sortcount.unpack_stream(jnp.asarray(p), jnp.asarray(m), 777)
    got = np.where(np.asarray(inval) == 1, 4, np.asarray(dev_codes)).astype(np.uint8)
    np.testing.assert_array_equal(got, codes)


# -- end-to-end golden equality ----------------------------------------------

@pytest.mark.parametrize("k", [5, 13, 16, 17, 31, 32, 33, 51, 63])
def test_golden_equality(k):
    rng = np.random.default_rng(k)
    codes = _random_stream(rng, 3000)
    c = _counter(k).count_codes(codes)
    assert c.as_dict() == codec.golden_count(codes, k)


@pytest.mark.parametrize("k", [5, 13, 16, 17, 31, 32, 33, 51, 63, 101, 201])
def test_window_keys_packed_bit_equality(k):
    """window_keys_packed (direct shift-or extraction from packed words)
    is bit-identical to the per-character code formulation, including
    sentinel rows, across word-boundary k values and separator layouts."""
    import jax.numpy as jnp

    rng = np.random.default_rng(100 + k)
    n = 1 << 9                       # multiple of 16 (packed-path contract)
    for p_sep in (0.0, 0.02, 0.3):
        stream = _random_stream(rng, n + k - 1, p_sep=p_sep)
        p, m = sortcount.pack_stream_np(stream)
        codes = sortcount.unpack_codes(jnp.asarray(p), jnp.asarray(m), n + k - 1)
        ref = sortcount.window_keys_from_codes(codes, k, n, 1 << 5)
        inv = sortcount.invalid_from_dense(jnp.asarray(m), n + k - 1)
        got = sortcount.window_keys_packed(jnp.asarray(p), inv, k, n)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
        # sparse separator vector builds the same invalid mask
        seps = np.flatnonzero(stream >= 4).astype(np.uint32)
        inv2 = sortcount.invalid_from_sparse(jnp.asarray(seps), n + k - 1)
        got2 = sortcount.window_keys_packed(jnp.asarray(p), inv2, k, n)
        for g, r in zip(got2, ref):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


@pytest.mark.parametrize("k", [31, 32, 51])
def test_golden_equality_packed_winkeys(k):
    """End-to-end golden equality with the packed window-key extraction
    (embedded-count and separate-count supersteps)."""
    rng = np.random.default_rng(7 * k)
    codes = _random_stream(rng, 3000)
    golden = codec.golden_count(codes, k)
    c = _counter(k, winkeys="packed").count_codes(codes)
    assert c.as_dict() == golden


def test_multi_batch_and_carry():
    """Stream large enough to span several batches; windows crossing batch
    boundaries must be counted exactly once."""
    k = 21
    rng = np.random.default_rng(7)
    codes = _random_stream(rng, 40000, p_sep=0.01)
    c = _counter(k)
    # feed in awkward chunk sizes
    i = 0
    for sz in (1, 13, 999, 5000, 17, 34000):
        c.add_codes(codes[i : i + sz])
        i += sz
    c.add_codes(codes[i:])
    c.finish()
    assert c.as_dict() == codec.golden_count(codes, k)


def test_compaction_and_growth():
    """Tiny prefix forces repeated merges and at least one growth."""
    k = 9
    rng = np.random.default_rng(3)
    codes = _random_stream(rng, 120000, p_sep=0.005)
    c = _counter(k, prefix_cap=1 << 10)
    c.count_codes(codes)
    assert c.stats["compactions"] >= 2
    assert c.stats["grow_events"] >= 1
    assert c.as_dict() == codec.golden_count(codes, k)


def test_revcomp_invariance():
    """count(seq) == count(revcomp(seq)) — canonicalization property."""
    k = 15
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, size=4000).astype(np.uint8)
    rc = (3 - codes)[::-1].astype(np.uint8)
    a = _counter(k).count_codes(codes).as_dict()
    b = _counter(k).count_codes(rc).as_dict()
    assert a == b


def test_total_count_equals_windows():
    k = 11
    rng = np.random.default_rng(6)
    codes = rng.integers(0, 4, size=5000).astype(np.uint8)  # no separators
    c = _counter(k).count_codes(codes)
    assert sum(c.as_dict().values()) == 5000 - k + 1


# -- modes / output contract -------------------------------------------------

def test_mode_clipping():
    k = 4
    codes = np.tile(np.array([0, 1, 2, 3], np.uint8), 5000)  # one dominant kmer
    kaarme = _counter(k, mode=2).count_codes(codes).as_dict()
    plain = _counter(k, mode=0).count_codes(codes).as_dict()
    # saturation vs wrap behaviour must differ once count > 16383
    golden = codec.golden_count(codes, k)
    assert all(v == min(golden[km], 16383) for km, v in kaarme.items())
    for km, v in plain.items():
        assert v == golden[km] & 0xFFFF


def test_min_abundance_filter():
    k = 7
    rng = np.random.default_rng(9)
    codes = _random_stream(rng, 9000)
    g = codec.golden_count(codes, k)
    c = _counter(k, min_abundance=2).count_codes(codes)
    expect = {km: v for km, v in g.items() if v >= 2}
    assert c.as_dict() == expect


def test_write_output_sorted(tmp_path):
    k = 8
    rng = np.random.default_rng(11)
    codes = _random_stream(rng, 6000)
    c = _counter(k).count_codes(codes)
    out = tmp_path / "counts.txt"
    n = c.write_output(str(out))
    lines = out.read_text().splitlines()
    assert len(lines) == n
    kmers = [ln.split()[0] for ln in lines]
    assert kmers == sorted(kmers)
    got = {ln.split()[0]: int(ln.split()[1]) for ln in lines}
    assert got == codec.golden_count(codes, k)


# -- queries -----------------------------------------------------------------

def test_find():
    k = 13
    rng = np.random.default_rng(13)
    codes = _random_stream(rng, 5000)
    c = _counter(k).count_codes(codes)
    g = codec.golden_count(codes, k)
    some = list(g)[:20]
    got = c.find(some)
    assert got == [g[s] for s in some]
    # absent + malformed
    assert c.find(["A" * k]) == [g.get("A" * k, 0)]
    assert c.find(["N" * k, "A" * (k - 1)]) == [-1, -1]
    # non-canonical query resolves via its canonical form
    s = some[0]
    assert c.find([codec.revcomp(s)]) == [g[s]]


def test_file_pipeline(tmp_path):
    k = 17
    rng = np.random.default_rng(17)
    seqs = ["".join(rng.choice(list("ACGT"), size=rng.integers(k, 200)))
            for _ in range(40)]
    fa = tmp_path / "reads.fasta"
    fa.write_text("".join(f">r{i} desc\n{s}\n" for i, s in enumerate(seqs)))
    c = _counter(k)
    c.count_file(str(fa))
    golden: dict = {}
    for s in seqs:
        for i in range(len(s) - k + 1):
            km = codec.canonical(s[i : i + k])
            golden[km] = golden.get(km, 0) + 1
    assert c.as_dict() == golden


def test_sort_backend_matches_table_backend():
    """Cross-backend oracle check: the sort pipeline and the batched
    probe-table pipeline produce identical count multisets."""
    from kaarme_tpu.models.counter import CounterConfig, KmerCounter

    k = 13
    rng = np.random.default_rng(42)
    codes = _random_stream(rng, 20000, p_sep=0.01)
    srt = _counter(k).count_codes(codes).as_dict()
    tbl = KmerCounter(CounterConfig(
        k=k, min_slots=1 << 15, tile=1 << 10, batch_tiles=4,
        min_abundance=1)).count_codes(codes).as_dict()
    assert srt == tbl


@pytest.mark.parametrize("k", [101, 201])
def test_long_kmers(k):
    """Long k-mers (the reference's headline use case): multi-word keys
    far beyond 64 bases."""
    rng = np.random.default_rng(k)
    codes = _random_stream(rng, 2500, p_sep=0.01)
    c = _counter(k, batch_windows=1 << 11, rows=1 << 5, prefix_cap=1 << 12)
    c.count_codes(codes)
    assert c.as_dict() == codec.golden_count(codes, k)


# -- overflow / clamp invariants (round-2 advisor findings) ------------------

def test_hot_key_count_clamp_across_merges():
    """A single hot k-mer whose total count exceeds the 2^20 clamp must
    still honor both output contracts after many streaming merges
    (advisor: unclamped prefix sums corrupted embedded counts)."""
    k = 17  # k%16 == 1 -> embedded path eligible (30 free bits)
    n = (1 << 20) + 84 + (k - 1)  # poly-A: (1<<20)+84 identical windows
    codes = np.zeros(n, np.uint8)
    total = n - k + 1
    for mode, expect in ((2, 16383), (0, total % 65536)):
        c = _counter(k, mode=mode, batch_windows=1 << 14, rows=1 << 7,
                     merge_every=2)
        c.count_codes(codes)
        got = c.as_dict()
        assert got == {"A" * k: expect}


def test_compact_exact_beyond_int32_cumsum():
    """compact() segment sums stay exact when the GLOBAL count mass
    exceeds int32 (advisor: the old int32 cumsum wrapped negative).
    8192 distinct keys x count 2^20 = 2^33 total mass."""
    import jax.numpy as jnp

    n = 8192
    w = 2
    k0 = np.arange(n, dtype=np.uint32)
    k1 = np.full(n, 7, np.uint32)
    cnt = np.full(n, 1 << 20, np.int32)
    # duplicate one key across the would-be wrap boundary
    k0[n - 1] = k0[0]
    store = (jnp.asarray(k0), jnp.asarray(k1), jnp.asarray(cnt))
    out, nd = sortcount.compact(store)
    nd = int(nd)
    assert nd == n - 1
    out_c = np.asarray(out[-1][:nd])
    # the duplicated key sums to 2^21 -> clamped to 2^20 + 0
    expected = {(1 << 20): n - 2, (1 << 20) + ((1 << 21) % (1 << 20)): 1}
    vals, counts = np.unique(out_c, return_counts=True)
    got = dict(zip(vals.tolist(), counts.tolist()))
    assert got == {(1 << 20): n - 1} or got == expected


def test_embedded_merge_prefix_plus_units():
    """Embedded no-cumsum path: segment sum = prefix count + unit rows
    (counts live in the trailing word's low bits, so the non-unit row
    sorts last within its segment)."""
    k = 17
    codes = np.zeros(100 + k - 1, np.uint8)  # 100 poly-A windows
    c = _counter(k, batch_windows=1 << 5, rows=1 << 2, merge_every=2)
    c.count_codes(codes)   # several merges: prefix-count + unit-run adds
    assert c.as_dict() == {"A" * k: 100}


def test_compact_clamped_beyond_uint32_segment_mass():
    """compact(clamped=True) stays exact when ONE segment's true mass
    exceeds 2^32 (advisor r3: skm finalize feeds one clamped row per
    distinct run containing a k-mer — rows per segment is unbounded).
    4096 rows x 2^20 = exactly 2^32 true mass: the wrapped-cumsum
    difference reads 0 (the wrap preserves mod 2^20, so the failure
    regime is a wrapped sum landing <= 2^20 — here the key VANISHES);
    the clamped segmented scan must stay exact."""
    import jax.numpy as jnp

    n = 8192
    rows = 4096
    per = 1 << 20
    k0 = np.arange(n, dtype=np.uint32)
    k0[:rows] = 42
    k1 = np.full(n, 3, np.uint32)
    cnt = np.full(n, 1, np.int32)
    cnt[:rows] = per
    store = (jnp.asarray(k0), jnp.asarray(k1), jnp.asarray(cnt))
    out, nd = sortcount.compact(store, clamped=True)
    nd = int(nd)
    assert nd == n - rows + 1
    keys0 = np.asarray(out[0][:nd])
    cnts = np.asarray(out[-1][:nd])
    true_sum = rows * per
    expect = (1 << 20) + (true_sum % (1 << 20))
    assert cnts[keys0 == 42].tolist() == [expect]
    # every singleton key keeps count 1 (scan must not leak across segments)
    assert (cnts[keys0 != 42] == 1).all()
    # and the default path provably corrupts here (documents the hazard):
    # the wrapped segment sum reads 0, so the key is partitioned DEAD
    out2, nd2 = sortcount.compact(store)
    k2 = np.asarray(out2[0][: int(nd2)])
    c2 = np.asarray(out2[-1][: int(nd2)])
    assert 42 not in k2.tolist() or c2[k2 == 42].tolist() != [expect]


def test_compact_clamped_matches_default_in_bounded_regime():
    """Random bounded-mass stores: clamped and default compact agree."""
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    for trial in range(3):
        n = 4096
        k0 = rng.integers(0, 50, n).astype(np.uint32)
        k1 = rng.integers(0, 3, n).astype(np.uint32)
        cnt = rng.integers(1, 1000, n).astype(np.int32)
        # sprinkle sentinels
        sent = rng.random(n) < 0.1
        k0[sent] = 0xFFFFFFFF
        k1[sent] = 0xFFFFFFFF
        cnt[sent] = 0
        store = (jnp.asarray(k0), jnp.asarray(k1), jnp.asarray(cnt))
        a, nda = sortcount.compact(store)
        b, ndb = sortcount.compact(store, clamped=True)
        assert int(nda) == int(ndb)
        nd = int(nda)
        for ca, cb in zip(a, b):
            assert np.array_equal(np.asarray(ca[:nd]), np.asarray(cb[:nd]))
