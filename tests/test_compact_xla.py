"""XLA compaction (ops/sortcount.py ``_compact_embedded`` and
``compact``) against a NumPy segment-sum oracle, and the counting
supersteps built on it."""

import numpy as np
import jax.numpy as jnp
import pytest

from kaarme_tpu.ops import sortcount
from kaarme_tpu.utils import codec

SENT = 0xFFFFFFFF
BIG = 1 << 20


def _clamp(c: int) -> int:
    """The stored-count modular clamp (sortcount._clamp_count)."""
    return c if c <= BIG else BIG + (c & (BIG - 1))


def _embedded_rows(n_real, n_total, W, ebits, seed=0, max_c=1000):
    """Unsorted embedded-count rows: per key at most one non-unit count
    row plus unit rows (the streaming merge's contract), sentinel pad.
    Returns (columns, {key tuple: total})."""
    rng = np.random.default_rng(seed)
    n_keys = max(1, n_real // 3)
    keys = rng.integers(0, 1 << 32, size=(n_keys, W),
                        dtype=np.uint64).astype(np.uint32)
    keys[:, W - 1] &= np.uint32(~((1 << ebits) - 1) & 0xFFFFFFFF)
    keys[:, 0] &= 0x7FFFFFFF          # no accidental all-ones rows
    picks = rng.integers(0, n_keys, size=n_real)
    cnts = np.ones(n_real, np.uint32)
    seen = {}
    for i, p in enumerate(picks):
        seen.setdefault(int(p), i)
    for p in set(rng.integers(0, n_keys, size=n_keys // 2).tolist()):
        if p in seen:
            cnts[seen[p]] = rng.integers(2, max_c)
    exp = {}
    for p, c in zip(picks, cnts):
        key = tuple(int(x) for x in keys[p])
        exp[key] = exp.get(key, 0) + int(c)
    rows = keys[picks]
    cols = [rows[:, w].copy() for w in range(W)]
    cols[W - 1] |= cnts
    pad = n_total - n_real
    cols = [np.concatenate([c, np.full(pad, SENT, np.uint32)]) for c in cols]
    perm = rng.permutation(n_total)
    return [jnp.asarray(c[perm]) for c in cols], exp


def _store_dict(store, nd, sentinel_tail=True):
    """Live (key tuple -> count) of a compacted store; checks that the
    first nd rows are the sorted distinct records and the rest dead
    (count 0; sentinel keys too where the compaction writes them)."""
    keys = np.stack([np.asarray(c) for c in store[:-1]], axis=1)
    cnt = np.asarray(store[-1]).astype(np.int64)
    assert (cnt[:nd] > 0).all() and (cnt[nd:] == 0).all()
    if sentinel_tail:
        assert (keys[nd:] == SENT).all()
    live = [tuple(int(x) for x in r) for r in keys[:nd]]
    assert live == sorted(live)
    return dict(zip(live, cnt[:nd].tolist()))


@pytest.mark.parametrize("n_real,blocks", [(500, 1), (6000, 8), (0, 1),
                                           (1023, 1)])
def test_compact_embedded_matches_numpy(n_real, blocks):
    W, ebits = 3, 26
    n_total = 1024 * blocks
    cols, exp = _embedded_rows(min(n_real, n_total - 1), n_total, W, ebits)
    store, nd = sortcount._compact_embedded(cols, ebits)
    got = _store_dict(store, int(nd))
    assert got == {k: _clamp(v) for k, v in exp.items()}


def test_compact_embedded_clamps_counts():
    """Totals above 2^20 get the contract-preserving modular clamp
    (reference saturation contract: source/kmer.cpp:699-713)."""
    W, ebits, n_real = 2, 26, 2048
    key = [np.zeros(4096, np.uint32) for _ in range(W)]
    key[0][:] = 17
    cnts = np.ones(4096, np.uint32)
    big = (1 << 20) + 12345
    cnts[n_real - 1] = big
    key[W - 1] |= cnts
    for w in range(W):
        key[w][n_real:] = SENT
    store, nd = sortcount._compact_embedded(
        [jnp.asarray(c) for c in key], ebits)
    assert int(nd) == 1
    assert int(np.asarray(store[-1])[0]) == _clamp(big + n_real - 1)


@pytest.mark.parametrize("vals", [
    [0x400001, 0x800001],
    [0x400001, 0x400001, 0x800001],
    [0x000001, 0x400001],
    [0x000001] * 22 + [0x400001],
])
def test_compact_embedded_adjacent_low_keybit(vals):
    """Adjacent segments whose keys differ only in the lowest key bit,
    just above the embedded count field."""
    eb = 22
    rows = np.array(vals + [SENT] * (256 - len(vals)),
                    np.uint64).astype(np.uint32)
    store, nd = sortcount._compact_embedded([jnp.asarray(rows)], eb)
    nd = int(nd)
    got = list(zip(np.asarray(store[0])[:nd].tolist(),
                   np.asarray(store[-1])[:nd].tolist()))
    exp = {}
    for v in vals:
        kv = v & ~((1 << eb) - 1)
        exp[kv] = exp.get(kv, 0) + (v & ((1 << eb) - 1))
    assert got == sorted(exp.items())


@pytest.mark.parametrize("n_real,blocks", [(500, 1), (6000, 8), (0, 1),
                                           (1023, 1)])
def test_compact_clamped_matches_numpy(n_real, blocks):
    """compact(clamped=True) — the finalize contract: separate count
    column, ANY number of non-unit rows per key."""
    W = 2
    n_total = 1024 * blocks
    n_real = min(n_real, n_total - 1)
    rng = np.random.default_rng(n_real + blocks)
    keys = rng.integers(0, max(n_real // 4, 1), n_real).astype(np.uint64)
    cnts = rng.integers(0, 1 << 21, n_real).astype(np.int64)
    cols = [(keys >> np.uint64(3)).astype(np.uint32),
            (keys & np.uint64(7)).astype(np.uint32)]
    cols = [np.concatenate([c, np.full(n_total - n_real, SENT, np.uint32)])
            for c in cols]
    cnt = np.concatenate([cnts, np.zeros(n_total - n_real, np.int64)])
    store, nd = sortcount.compact(
        tuple(jnp.asarray(c) for c in cols)
        + (jnp.asarray(cnt.astype(np.int32)),), clamped=True)
    exp = {}
    for kk, c in zip(keys.tolist(), cnts.tolist()):
        exp[kk] = _clamp(exp.get(kk, 0) + c)
    exp = {((kk >> 3), (kk & 7)): c for kk, c in exp.items() if c > 0}
    assert _store_dict(store, int(nd), sentinel_tail=False) == exp


@pytest.mark.parametrize("W,na_real,nb_real,kmax", [
    (2, 300, 1500, 700),        # overlap-heavy
    (3, 50, 4000, 1 << 20),     # mostly-new batch
    (1, 400, 100, 480),         # batch smaller than prefix
    (2, 0, 2000, 1000),         # empty prefix
    (2, 600, 0, 1000),          # empty batch
])
def test_merge_prefix_with_batch(W, na_real, nb_real, kmax):
    """One streaming merge: a compacted prefix (one row per key, any
    count < 2^21) plus a batch of unit rows, as the embedded superstep
    concatenates them."""
    rng = np.random.default_rng(W * 1000 + na_real + nb_real)
    eb = 22
    akeys = np.unique(rng.integers(0, kmax, na_real).astype(np.uint64)) \
        if na_real else np.empty(0, np.uint64)
    acnt = rng.integers(1, 1 << 19, akeys.shape[0]).astype(np.uint64)
    bkeys = rng.integers(0, kmax, nb_real).astype(np.uint64)

    def split(vals, cnts):
        cols = [((vals >> np.uint64(9 * (W - 1 - w))) & np.uint64(0x1FF))
                .astype(np.uint32) for w in range(W - 1)]
        cols.append((((vals & np.uint64(0x1FF)) << np.uint64(eb)) | cnts)
                    .astype(np.uint32))
        return cols

    a, b = split(akeys, acnt), split(bkeys, np.ones(nb_real, np.uint64))
    pad = 128
    cols = [jnp.asarray(np.concatenate([x, y, np.full(pad, SENT, np.uint32)]))
            for x, y in zip(a, b)]
    store, nd = sortcount._compact_embedded(cols, eb)
    nd = int(nd)
    exp = {}
    for kk, c in zip(akeys.tolist(), acnt.tolist()):
        exp[kk] = exp.get(kk, 0) + c
    for kk in bkeys.tolist():
        exp[kk] = exp.get(kk, 0) + 1
    got_k = np.zeros(nd, np.uint64)
    for w in range(W - 1):
        got_k = (got_k << np.uint64(9)) | np.asarray(store[w])[:nd].astype(np.uint64)
    got_k = (got_k << np.uint64(9)) | \
        (np.asarray(store[W - 1])[:nd].astype(np.uint64) >> np.uint64(eb))
    got = list(zip(got_k.tolist(), np.asarray(store[-1])[:nd].tolist()))
    assert got == sorted((kk, _clamp(c)) for kk, c in exp.items())


def test_merge_hot_key_clamps():
    """One key carried in the prefix near the clamp plus a batch full of
    it: the merged count takes the modular clamp."""
    eb, n = 22, 4096
    k0 = np.uint32(5 << eb)
    prefix = np.array([k0 | np.uint32(900000)], np.uint32)
    batch = np.full(n, k0 | np.uint32(1), np.uint32)
    col = np.concatenate([prefix, batch, np.full(127, SENT, np.uint32)])
    store, nd = sortcount._compact_embedded([jnp.asarray(col)], eb)
    assert int(nd) == 1
    assert int(np.asarray(store[-1])[0]) == _clamp(900000 + n)


def test_merge_exact_fit_no_sentinels():
    """Every row real (no sentinel padding at all): the last segment is
    still emitted."""
    rng = np.random.default_rng(2)
    eb, n = 22, 1024
    keys = rng.integers(0, 1 << 9, n).astype(np.uint32)
    col = (keys << np.uint32(eb)) | np.uint32(1)
    store, nd = sortcount._compact_embedded([jnp.asarray(col)], eb)
    nd = int(nd)
    uk, uc = np.unique(keys, return_counts=True)
    assert nd == uk.shape[0]
    assert (np.asarray(store[0])[:nd] >> np.uint32(eb) == uk).all()
    assert (np.asarray(store[-1])[:nd] == uc).all()


@pytest.mark.parametrize("k", [13, 31, 51, 63])
def test_superstep_matches_golden(k):
    """One counting superstep on an empty prefix equals the golden
    oracle: the embedded-count superstep where the trailing key word
    has >= 21 free bits, the separate-count one elsewhere."""
    n, rows = 1 << 12, 1 << 5
    eb = sortcount.embed_bits(k)
    rng = np.random.default_rng(11 + k)
    codes = rng.integers(0, 5, size=n + k - 1).astype(np.uint8)
    packed, _ = sortcount.pack_stream_np(codes)
    seps = np.flatnonzero(codes >= 4).astype(np.uint32)
    sep = np.full(max(n // 32, seps.shape[0]), n + k - 1, np.uint32)
    sep[: seps.shape[0]] = seps
    prefix = sortcount.make_store(1 << 13, sortcount.words_per_kmer(k))
    if eb >= 21:
        store, ndv = sortcount.superstep_embedded(
            jnp.asarray(packed), jnp.asarray(sep), prefix,
            k=k, n=n, rows=rows, ebits=eb)
    else:
        store, ndv = sortcount.superstep_plain(
            jnp.asarray(packed), jnp.asarray(sep), prefix,
            k=k, n=n, rows=rows)
    nd_exact, nd_used = (int(x) for x in np.asarray(ndv))
    assert nd_exact == nd_used
    keys = np.stack([np.asarray(c)[:nd_exact] for c in store[:-1]], axis=1)
    got = dict(zip(codec.unpack_kmers(keys, k),
                   np.asarray(store[-1])[:nd_exact].tolist()))
    assert got == codec.golden_count(codes, k)
