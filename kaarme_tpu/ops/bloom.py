"""Two-stage BLOCKED Bloom prefilter (device side, JAX/XLA).

Device rebuild of the reference's ``DoubleAtomicDoubleBloomFilter``
(reference: include/double_bloomfilter.hpp:233-452): BF1 = "seen at
least once", BF2 = "seen at least twice"; pass 1 populates both, the
table is sized from the BF2 cardinality counter, then BF1 is dropped
("squeeze", reference: include/mybitarray.hpp:127-162) and pass 2 counts
only k-mers whose bits are all set in BF2.

Design differences:
- **blocked layout**: all ``hfn`` bits of a key live in ONE uint32 word
  (word index from r1, bit pattern from r2 via double hashing with an
  odd stride — a permutation of the 32 bit positions, so the hfn bits
  are always distinct).  Membership is ONE gather + compare instead of
  hfn gathers, and the classical layout's converging-scatter insert
  held hfn x n index/mask/pending arrays live (~5 GB at the bench
  shape).  Blocked
  trades a higher per-word false-positive rate for that; the allocation
  site compensates with ``BLOCK_COMPENSATION`` x the reference bit
  count (memory is trivial: the reference sizing is ~8 MB/stage).
  False positives never change output: they only admit singletons that
  the min-abundance threshold drops (same property as the reference).
- **exact sort-based insert**: instead of CAS bit-sets (reference:
  mybitarray.hpp:87-125) or a converging scatter loop, active (word,
  mask) pairs are sorted by word, masks are OR-combined per word with a
  log-shift segmented scan (OR is associative + idempotent), and each
  word's combined mask lands with ONE scatter at unique indices — no
  convergence loop, no contention, bounded memory.
- the sequential "first occurrence sets BF1, second sets BF2" semantics
  (reference: double_bloomfilter.hpp:371-413) is recovered batch-wise by
  sorting the batch's root hashes and ranking duplicates in-segment, so
  a doubleton entirely inside one batch still lands in BF2.

House performance rules apply (ops/sortcount.py module docstring): no
boolean tensors at fusion boundaries on the hot paths — insert_batch
and the mask helpers carry int32 {0,1} / all-ones uint32 masks.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# Extra bits allocated per stage versus the reference formula, to buy
# back the blocked layout's false-positive inflation (all hfn bits in
# one word).  At the reference's ~16 bits/key sizing this puts ~0.5
# keys per 32-bit word and the measured fpr well under the requested
# 0.01 (see tests/test_bloom.py roundtrip/fp assertions).
BLOCK_COMPENSATION = 4

_B = jax.lax.optimization_barrier


def make_bloom(bits: int):
    """One stage's bit array as uint32 words; ``bits`` is a power of two."""
    assert bits % 32 == 0 and bits & (bits - 1) == 0
    return jnp.zeros((bits // 32,), jnp.uint32)


def _word_mask(r1, r2, hfn: int, nwords: int):
    """Blocked addressing: (word index int32, hfn-bit uint32 mask).

    Word from r1; bit positions b_j = (b0 + j * stride) mod 32 with an
    ODD stride — a permutation of Z_32, so the hfn (< 32) bits are
    pairwise distinct (denser masks would raise the false-positive
    rate)."""
    w = (r1 & jnp.uint32(nwords - 1)).astype(jnp.int32)
    b0 = r2 & jnp.uint32(31)
    stride = ((r2 >> jnp.uint32(5)) | jnp.uint32(1)) & jnp.uint32(31)
    mask = jnp.zeros(r2.shape, jnp.uint32)
    for j in range(hfn):
        bj = (b0 + jnp.uint32(j) * stride) & jnp.uint32(31)
        mask = mask | (jnp.uint32(1) << bj)
    return w, mask


def contains_i32(bf, r1, r2, hfn: int):
    """int32 {0,1} where all hfn bits are set — ONE gather per key."""
    w, mask = _word_mask(r1, r2, hfn, bf.shape[0])
    d = (bf[w] & mask) ^ mask
    # 0 iff all bits present
    return 1 - ((d | (jnp.uint32(0) - d)) >> jnp.uint32(31)).astype(jnp.int32)


def contains(bf, r1, r2, hfn: int):
    """Boolean convenience wrapper (tests / small queries)."""
    return contains_i32(bf, r1, r2, hfn) == 1


def set_bits(bf, r1, r2, hfn: int, active, max_rounds: int | None = None):
    """Set all hfn bits for the active elements — EXACT, loop-free.

    Sort (word, mask) by word with inactive rows keyed past the end,
    OR-combine masks per word with a log-shift segmented inclusive scan
    (OR is associative and idempotent, so the scan needs no segment
    bookkeeping beyond the word key itself), keep each word's last row,
    and scatter the combined masks at now-unique indices.  Every bit of
    every active element lands: no convergence loop, no contention
    (regression: tests/test_bloom.py::test_set_bits_converges_under_
    contention).  ``max_rounds`` is accepted for API compatibility and
    ignored.
    """
    nwords = bf.shape[0]
    w, mask = _word_mask(r1, r2, hfn, nwords)
    if active.dtype == jnp.bool_:
        act = active.astype(jnp.int32)
    else:
        act = jnp.minimum(active.astype(jnp.int32), 1)
    # inactive rows: word -> nwords (sorts last, drops at scatter), mask 0
    w = jnp.where(act == 1, w, jnp.int32(nwords))
    mask = mask * act.astype(jnp.uint32)

    sw, sm = jax.lax.sort((w, mask), num_keys=1)
    sw, sm = _B((sw, sm))

    n = sw.shape[0]
    idx = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    sh = 1
    while sh < n:
        pm = jnp.roll(sm, sh)
        pw = jnp.roll(sw, sh)
        d = jax.lax.bitcast_convert_type(sw ^ pw, jnp.uint32)
        same = (1 - ((d | (jnp.uint32(0) - d)) >> jnp.uint32(31)).astype(jnp.int32)) \
            * jnp.minimum(jnp.maximum(idx - (sh - 1), 0), 1)
        sm = sm | (pm * same.astype(jnp.uint32))
        sm = _B(sm)
        sh <<= 1
    # last row of each word segment: the next row has a different word
    nxt = jnp.concatenate([sw[1:], jnp.full((1,), -1, jnp.int32)])
    d2 = jax.lax.bitcast_convert_type(sw ^ nxt, jnp.uint32)
    is_last = ((d2 | (jnp.uint32(0) - d2)) >> jnp.uint32(31)).astype(jnp.int32)
    tgt = jnp.where(is_last == 1, sw, jnp.int32(nwords))
    upd = bf[jnp.minimum(tgt, nwords - 1)] | sm
    return bf.at[tgt].set(upd, mode="drop")


@partial(jax.jit, static_argnames=("hfn",), donate_argnums=(0, 1))
def insert_batch(bf1, bf2, r1, r2, valid, hfn: int):
    """Pass-1 insertion of a batch of root hashes.

    Returns (bf1, bf2, new_in_first, new_in_second) — the counters mirror
    the reference's exactly-once accounting used for table sizing
    (reference: double_bloomfilter.hpp:264-274, main.cpp:454).
    """
    n = r1.shape[0]
    # sort so duplicate roots are adjacent; invalid entries go last.
    if valid.dtype == jnp.bool_:
        val = valid.astype(jnp.int32)
    else:
        val = jnp.minimum(valid.astype(jnp.int32), 1)
    inval = 1 - val
    s_inval, sr1, sr2 = jax.lax.sort((inval, r1, r2), num_keys=3)
    s_inval, sr1, sr2 = _B((s_inval, sr1, sr2))
    sval = 1 - s_inval

    idx = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    prev_r1 = jnp.roll(sr1, 1)
    prev_r2 = jnp.roll(sr2, 1)
    dd = jax.lax.bitcast_convert_type(sr1 ^ prev_r1, jnp.uint32) \
        | jax.lax.bitcast_convert_type(sr2 ^ prev_r2, jnp.uint32)
    neq = ((dd | (jnp.uint32(0) - dd)) >> jnp.uint32(31)).astype(jnp.int32)
    newseg = jnp.maximum(neq, 1 - jnp.minimum(idx, 1))
    seg_start = jax.lax.cummax(newseg * idx)
    seg_start = _B(seg_start)
    ordinal = idx - seg_start

    first = sval * (1 - jnp.minimum(ordinal, 1))
    in1 = contains_i32(bf1, sr1, sr2, hfn)
    in2 = contains_i32(bf2, sr1, sr2, hfn)

    set1 = first * (1 - in1)
    # BF2 is reached when a prior pass saw the key once (first & in1) or
    # when the batch itself holds a second occurrence (ordinal == 1 of a
    # segment whose key was not yet in BF1).
    second = (1 - jnp.minimum(jnp.abs(ordinal - 1), 1)) * (1 - in1)
    set2 = sval * (1 - in2) * jnp.maximum(first * in1, second)

    new1 = jnp.sum(set1)
    new2 = jnp.sum(set2)
    bf1 = set_bits(bf1, sr1, sr2, hfn, set1)
    bf2 = set_bits(bf2, sr1, sr2, hfn, set2)
    return bf1, bf2, new1, new2
