import numpy as np
import pytest

import jax.numpy as jnp

from kaarme_tpu.models.bloom_counter import (
    BloomCounterConfig,
    bloom_count_codes,
    bloom_count_file,
)
from kaarme_tpu.ops import bloom as bloom_ops
from kaarme_tpu.utils import codec
from kaarme_tpu.utils.mathutils import bloom_sizing


def test_bloom_sizing_matches_reference_formula():
    bits, hfn = bloom_sizing(4_000_000, 0.01)
    # -4e6 * ln(0.01) / ln(2)^2 = 38340233.9 -> next pow2 = 2^26
    assert bits == 1 << 26
    assert hfn == 7


def test_set_and_contains_roundtrip():
    bf = bloom_ops.make_bloom(1 << 12)
    rng = np.random.default_rng(0)
    r1 = jnp.asarray(rng.integers(0, 2**32, size=100, dtype=np.uint32))
    r2 = jnp.asarray(rng.integers(0, 2**32, size=100, dtype=np.uint32))
    active = jnp.asarray(np.arange(100) % 2 == 0)
    bf = bloom_ops.set_bits(bf, r1, r2, 5, active)
    got = np.asarray(bloom_ops.contains(bf, r1, r2, 5))
    np.testing.assert_array_equal(got[::2], True)
    # odd entries may be false positives but with 4096 bits / 250 set this
    # should be rare; require at least most to be absent
    assert got[1::2].sum() < 10


def test_insert_batch_two_stage_semantics():
    bf1 = bloom_ops.make_bloom(1 << 14)
    bf2 = bloom_ops.make_bloom(1 << 14)
    rng = np.random.default_rng(1)
    singles = rng.integers(0, 2**32, size=(50, 2), dtype=np.uint32)
    doubles = rng.integers(0, 2**32, size=(30, 2), dtype=np.uint32)
    batch = np.concatenate([singles, doubles, doubles])
    perm = rng.permutation(batch.shape[0])
    batch = batch[perm]
    r1 = jnp.asarray(batch[:, 0])
    r2 = jnp.asarray(batch[:, 1])
    valid = jnp.ones((batch.shape[0],), jnp.bool_)
    bf1, bf2, n1, n2 = bloom_ops.insert_batch(bf1, bf2, r1, r2, valid, 5)
    assert int(n1) == 80  # 50 singles + 30 distinct doubles newly in BF1
    assert int(n2) == 30  # only in-batch doubletons reach BF2

    # doubles are in BF2; singles are not (modulo fp)
    in2_d = np.asarray(bloom_ops.contains(bf2, jnp.asarray(doubles[:, 0]), jnp.asarray(doubles[:, 1]), 5))
    assert in2_d.all()
    in2_s = np.asarray(bloom_ops.contains(bf2, jnp.asarray(singles[:, 0]), jnp.asarray(singles[:, 1]), 5))
    assert in2_s.sum() < 5

    # a second pass over the singles promotes them to BF2
    bf1, bf2, n1b, n2b = bloom_ops.insert_batch(
        bf1, bf2, jnp.asarray(singles[:, 0]), jnp.asarray(singles[:, 1]),
        jnp.ones((50,), jnp.bool_), 5,
    )
    assert int(n1b) == 0
    in2_s2 = np.asarray(bloom_ops.contains(bf2, jnp.asarray(singles[:, 0]), jnp.asarray(singles[:, 1]), 5))
    assert in2_s2.all()


def _mixed_input(seed=0):
    """Reads where some k-mers occur once and some repeat."""
    rng = np.random.default_rng(seed)
    core = "".join("ACGT"[c] for c in rng.integers(0, 4, size=400))
    uniq = "".join("ACGT"[c] for c in rng.integers(0, 4, size=400))
    text = core + "\n" + core + "\n" + uniq
    return codec.encode_plain(text.encode())


def test_bloom_two_pass_counts_repeated_kmers_exactly():
    k = 11
    codes = _mixed_input()
    golden = codec.golden_count(codes, k)
    cfg = BloomCounterConfig(
        k=k, expected_unique=2000, fpr=0.01, min_abundance=2,
        tile=128, batch_tiles=4,
    )
    c = bloom_count_codes(cfg, codes)
    got = c.as_dict()
    expect = {s: n for s, n in golden.items() if n >= 2}
    # every k-mer with count >= 2 must be present with its exact count
    for s, n in expect.items():
        assert got.get(s) == n, (s, n, got.get(s))
    # nothing below min_abundance leaks into the output
    assert all(n >= 2 for n in got.values())
    # BF mode output must be a subset of golden
    assert all(golden.get(s) == n for s, n in got.items())
    assert c.stats["new_in_second"] >= len(expect)


def test_bloom_count_file_matches_in_memory(tmp_path):
    k = 9
    codes = _mixed_input(seed=3)
    text = codec.decode_codes(codes).replace("N", "\n")
    p = tmp_path / "reads.txt"
    p.write_text(text + "\n")
    cfg = BloomCounterConfig(
        k=k, expected_unique=2000, fpr=0.01, min_abundance=2,
        tile=128, batch_tiles=4,
    )
    c_file = bloom_count_file(cfg, str(p))
    c_mem = bloom_count_codes(cfg, codec.encode_plain(p.read_bytes()))
    assert c_file.as_dict() == c_mem.as_dict()


# -- two-pass Bloom on the SORT backend (flagship path) ---------------------

def _sort_cfg(k, **kw):
    from kaarme_tpu.models.sort_counter import SortCounterConfig
    kw.setdefault("batch_windows", 1 << 10)
    kw.setdefault("rows", 1 << 5)
    kw.setdefault("superbatch_batches", 2)
    kw.setdefault("prefix_cap", 1 << 12)
    kw.setdefault("min_abundance", 2)
    return SortCounterConfig(k=k, **kw)


def test_bloom_sort_backend_drops_singletons_exactly():
    """No false negatives: every k-mer with true count >= 2 survives the
    filter with its exact count; singletons are absent (BF false
    positives are removed by the min-abundance threshold)."""
    from kaarme_tpu.models.bloom_counter import bloom_sort_count_codes

    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, 30000).astype(np.uint8)
    codes[rng.random(30000) < 0.01] = 4
    codes = np.concatenate([codes, codes[:9000]])   # duplication pressure
    k = 13
    c = bloom_sort_count_codes(_sort_cfg(k), 4000, 0.01, codes)
    golden2 = {km: n for km, n in codec.golden_count(codes, k).items() if n >= 2}
    assert c.as_dict() == golden2
    assert c.stats["new_in_second"] >= len(golden2)  # sized from BF2


def test_bloom_sort_backend_matches_table_backend():
    """Parity: the sort-backend filter and the probe-table filter agree
    on the count->=2 set."""
    from kaarme_tpu.models.bloom_counter import (
        BloomCounterConfig, bloom_count_codes, bloom_sort_count_codes)

    rng = np.random.default_rng(12)
    codes = rng.integers(0, 4, 20000).astype(np.uint8)
    codes = np.concatenate([codes, codes[5000:12000]])
    k = 11
    a = bloom_sort_count_codes(_sort_cfg(k), 3000, 0.01, codes).as_dict()
    b = bloom_count_codes(
        BloomCounterConfig(k=k, expected_unique=3000, tile=512,
                           batch_tiles=8), codes).as_dict()
    assert a == b


def test_bloom_sort_backend_long_k_plain_superstep():
    """k with < 21 embed bits exercises the plain superstep's filter."""
    from kaarme_tpu.models.bloom_counter import bloom_sort_count_codes

    rng = np.random.default_rng(13)
    codes = rng.integers(0, 4, 9000).astype(np.uint8)
    codes = np.concatenate([codes, codes])
    k = 27  # 27 % 16 = 11 -> embed_bits = 10 < 21
    c = bloom_sort_count_codes(_sort_cfg(k), 2000, 0.01, codes)
    golden2 = {km: n for km, n in codec.golden_count(codes, k).items() if n >= 2}
    assert c.as_dict() == golden2


def test_set_bits_converges_under_contention():
    """Many distinct keys hashing into few words must ALL land (the old
    16-round cap dropped bits -> Bloom false negatives -> lost k-mers)."""
    import jax.numpy as jnp
    from kaarme_tpu.ops import bloom as bloom_ops

    bf = bloom_ops.make_bloom(1 << 10)   # 32 words -> heavy contention
    n = 4096
    r1 = jnp.arange(n, dtype=jnp.uint32) * jnp.uint32(2654435761)
    r2 = jnp.arange(n, dtype=jnp.uint32) * jnp.uint32(40503) + jnp.uint32(7)
    bf = bloom_ops.set_bits(bf, r1, r2, 7, jnp.ones((n,), bool))
    ok = np.asarray(bloom_ops.contains(bf, r1, r2, 7))
    assert ok.all()


def _skm_cfg(k, **kw):
    from kaarme_tpu.models.skm_counter import SkmCounterConfig
    kw.setdefault("batch_windows", 1 << 14)
    kw.setdefault("rows", 1 << 9)
    kw.setdefault("superbatch_batches", 2)
    kw.setdefault("prefix_cap", 1 << 14)
    kw.setdefault("min_abundance", 2)
    return SkmCounterConfig(k=k, **kw)


def test_bloom_skm_drops_singletons_exactly():
    """--pipeline skm -b: the BF2 gate applied
    at finalize expansion yields exactly the count>=2 set — no false
    negatives, singletons absent (BF false positives are dropped by
    the min-abundance threshold)."""
    from kaarme_tpu.models.bloom_counter import bloom_skm_count_codes

    rng = np.random.default_rng(21)
    codes = rng.integers(0, 4, 60000).astype(np.uint8)
    codes[rng.random(60000) < 0.01] = 4
    codes = np.concatenate([codes, codes[:20000]])   # duplication pressure
    k = 19
    c = bloom_skm_count_codes(_skm_cfg(k), 8000, 0.01, codes)
    golden2 = {km: n for km, n in codec.golden_count(codes, k).items()
               if n >= 2}
    assert c.as_dict() == golden2
    assert c.stats["new_in_second"] >= len(golden2)


def test_bloom_skm_matches_bloom_sort():
    """skm -b and classic -b agree on the filtered output."""
    from kaarme_tpu.models.bloom_counter import (
        bloom_skm_count_codes, bloom_sort_count_codes)

    rng = np.random.default_rng(22)
    codes = rng.integers(0, 4, 40000).astype(np.uint8)
    codes = np.concatenate([codes, codes[10000:24000]])
    k = 21
    a = bloom_skm_count_codes(_skm_cfg(k), 6000, 0.01, codes).as_dict()
    b = bloom_sort_count_codes(_sort_cfg(
        k, batch_windows=1 << 12, rows=1 << 6), 6000, 0.01, codes).as_dict()
    assert a == b
