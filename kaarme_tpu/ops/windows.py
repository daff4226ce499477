"""Canonical k-mer window extraction (device side, JAX/XLA).

Replaces the reference's sequential per-character sliding factory
(``KMerFactoryCanonical2BC``, reference: source/kmer_factory.cpp:104-239)
with a fully vectorized formulation: for a tile of base codes all windows
are materialized at once via static shifted slices, so there is no
sequential dependence and the whole tile maps onto vector lanes.

Packing: base i of a window occupies word i//16 at bit 30 - 2*(i % 16)
(big-endian within and across words, trailing word left-aligned), so
lexicographic order over the base string equals numeric order over the
word tuple — the canonical pick (min of forward / reverse complement,
ties -> forward, reference: source/kmer_factory.cpp:219-233) is a
word-wise compare + select.

A window is valid iff all k codes are < 4; code 4 encodes the reference's
reset conditions (line breaks in plain mode, headers, non-ACGT bases).
"""

from __future__ import annotations

import jax.numpy as jnp

from .hashing import hash_words


def words_per_kmer(k: int) -> int:
    return (k + 15) // 16


def canonical_windows(codes, k: int):
    """All canonical k-mer windows of a code tile.

    Args:
      codes: uint8 array ``[..., L]`` of base codes in {0..4}.
      k: window length (static).

    Returns:
      keys:  tuple of W uint32 arrays ``[..., P]`` (packed canonical words),
      valid: bool array ``[..., P]``,
      with ``P = L - k + 1`` window positions.
    """
    L = codes.shape[-1]
    P = L - k + 1
    if P <= 0:
        raise ValueError(f"tile length {L} < k={k}")
    W = words_per_kmer(k)

    c32 = codes.astype(jnp.uint32)

    def pack(word_idx: int, rc: bool):
        acc = jnp.zeros(codes.shape[:-1] + (P,), jnp.uint32)
        for j in range(16):
            i = 16 * word_idx + j
            acc = acc << jnp.uint32(2)
            if i < k:
                if rc:
                    src = k - 1 - i
                    # complement 3-c; invalid codes (4) wrap but those
                    # windows are masked out by `valid`.
                    acc = acc | ((jnp.uint32(3) - c32[..., src : src + P]) & jnp.uint32(3))
                else:
                    acc = acc | c32[..., i : i + P]
        return acc

    fwd = [pack(w, rc=False) for w in range(W)]
    rcw = [pack(w, rc=True) for w in range(W)]

    # Lexicographic forward <= reverse-complement (ties -> forward).
    use_fwd = jnp.ones(fwd[0].shape, jnp.bool_)
    decided = jnp.zeros(fwd[0].shape, jnp.bool_)
    for f, r in zip(fwd, rcw):
        gt = f > r
        lt = f < r
        use_fwd = jnp.where(jnp.logical_and(~decided, gt), False, use_fwd)
        decided = decided | lt | gt

    keys = tuple(jnp.where(use_fwd, f, r) for f, r in zip(fwd, rcw))

    # Window validity: no code >= 4 inside [t, t+k).
    bad = (codes >= jnp.uint8(4)).astype(jnp.int32)
    cs = jnp.cumsum(bad, axis=-1)
    zero = jnp.zeros(codes.shape[:-1] + (1,), jnp.int32)
    cs0 = jnp.concatenate([zero, cs], axis=-1)  # [..., L+1]
    win_bad = cs0[..., k : k + P] - cs0[..., 0:P]
    valid = win_bad == 0

    return keys, valid


def windows_with_hash(codes, k: int):
    """Canonical windows + slot hash, flattened over leading dims.

    Returns ``(keys, valid, h)`` with keys a tuple of W uint32 ``[N]``
    arrays, valid ``[N]`` bool, h ``[N]`` uint32.
    """
    keys, valid = canonical_windows(codes, k)
    keys = tuple(kw.reshape(-1) for kw in keys)
    valid = valid.reshape(-1)
    h = hash_words(keys)
    return keys, valid, h
