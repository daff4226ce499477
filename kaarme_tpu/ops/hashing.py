"""Vectorized 32-bit mixers for packed k-mer keys (device side).

The reference uses a dual Rabin-Karp rolling hash over a prime modulus
(reference: source/hash_functions.cpp:102-208) because it updates one
character at a time on a CPU.  On the device all windows of a tile are
materialized at once, so rolling recurrences buy nothing; we hash the
packed canonical words directly with murmur3-style multiplicative mixing,
which is a handful of integer ops per word and gives uniform low bits so the
table can use power-of-two mask addressing.

Everything is uint32; XLA integer multiplies wrap mod 2^32 which is
exactly what the mixers need (no 64-bit lanes are assumed).
"""

from __future__ import annotations

import jax.numpy as jnp

_C1 = jnp.uint32(0xCC9E2D51)
_C2 = jnp.uint32(0x1B873593)
_M5 = jnp.uint32(5)
_N = jnp.uint32(0xE6546B64)


def _rotl(x, r: int):
    r = jnp.uint32(r)
    return (x << r) | (x >> (jnp.uint32(32) - r))


def fmix32(h):
    """murmur3 finalizer: full avalanche on a uint32 lane."""
    h = h ^ (h >> jnp.uint32(16))
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> jnp.uint32(13))
    h = h * jnp.uint32(0xC2B2AE35)
    h = h ^ (h >> jnp.uint32(16))
    return h


def hash_words(words, seed: int = 0x9747B28C):
    """murmur3_x86_32 over a tuple/list of uint32 arrays (word streams).

    ``words`` is a sequence of W arrays of identical shape; returns an
    array of that shape with the combined hash.
    """
    h = jnp.uint32(seed)
    for w in words:
        kx = w.astype(jnp.uint32) * _C1
        kx = _rotl(kx, 15)
        kx = kx * _C2
        h = h ^ kx
        h = _rotl(h, 13)
        h = h * _M5 + _N
    return fmix32(h ^ jnp.uint32(4 * len(words)))


def hash_words64(words, seed_lo: int = 0x9747B28C, seed_hi: int = 0x5BD1E995):
    """Two independent 32-bit hashes (used as a 64-bit Bloom root hash)."""
    return hash_words(words, seed_lo), hash_words(words, seed_hi)


def hash_words_np(words, seed: int = 0x9747B28C):
    """NumPy mirror of ``hash_words`` (host-side query routing must agree
    bit-for-bit with the device hash)."""
    import numpy as np

    def rotl(x, r):
        return ((x << np.uint32(r)) | (x >> np.uint32(32 - r))).astype(np.uint32)

    with np.errstate(over="ignore"):
        h = np.full(np.asarray(words[0]).shape, seed, np.uint32)
        for w in words:
            kx = np.asarray(w, np.uint32) * np.uint32(0xCC9E2D51)
            kx = rotl(kx, 15)
            kx = kx * np.uint32(0x1B873593)
            h = h ^ kx
            h = rotl(h, 13)
            h = h * np.uint32(5) + np.uint32(0xE6546B64)
        h = h ^ np.uint32(4 * len(words))
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        h = h ^ (h >> np.uint32(16))
    return h
