"""Sizing helpers.

The reference sizes its table with ``next_prime3mod4`` because its weak
polynomial rolling hash needs a prime modulus for quadratic probing
(reference: source/functions_math.cpp:53-96).  This rebuild uses strong
multiplicative mixing (murmur-style finalizers), so power-of-two capacities
with mask addressing are both correct and much cheaper on the device; probing
uses the triangular sequence h + i(i+1)/2 which is a full cycle mod 2^m.
"""

from __future__ import annotations

import math


def next_pow2(n: int) -> int:
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


def capacity_log2(min_slots: int) -> int:
    """Table capacity (log2) for a requested minimum slot count."""
    return max(8, (max(1, int(min_slots)) - 1).bit_length())


def next_prime(n: int) -> int:
    """Smallest prime >= n (trial division — host-side sizing only;
    reference: source/functions_math.cpp:7-51)."""
    n = max(2, int(n))
    while not _is_prime(n):
        n += 1
    return n


def next_prime3mod4(n: int) -> int:
    """Smallest prime >= n that is 3 (mod 4) — the reference's table
    sizing rule, kept for parity tooling (quadratic probes cover the
    whole table for such moduli; reference: source/functions_math.cpp:53-96).
    The device tables themselves use power-of-two capacities instead."""
    n = max(3, int(n))
    while n % 4 != 3 or not _is_prime(n):
        n += 1
    return n


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    if n % 2 == 0:
        return n == 2
    i = 3
    while i * i <= n:
        if n % i == 0:
            return False
        i += 2
    return True


def modular_inverse(a: int, m: int) -> int:
    """Multiplicative inverse of a mod m via extended Euclid
    (reference: source/functions_math.cpp:99-130)."""
    old_r, r = a % m, m
    old_s, s = 1, 0
    while r:
        q = old_r // r
        old_r, r = r, old_r - q * r
        old_s, s = s, old_s - q * s
    if old_r != 1:
        raise ValueError(f"{a} has no inverse mod {m}")
    return old_s % m


def power_under_modulo(base: int, exp: int, mod: int) -> int:
    """pow(base, exp, mod) — reference: source/functions_math.cpp."""
    return pow(int(base), int(exp), int(mod))


def bloom_sizing(expected_unique: int, fpr: float):
    """Bloom filter bits (rounded up to a power of two) and #hash functions.

    Mirrors the reference's derivation (reference: main.cpp:400-418):
    bits_min = -U * ln(fpr) / ln(2)^2, rounded UP to a power of two;
    hash functions = ceil((bits_min / U) * ln 2).
    """
    u = max(1, int(expected_unique))
    bits_min = (-float(u) * math.log(fpr)) / (math.log(2) ** 2)
    bits = 2
    while bits < int(bits_min):
        bits *= 2
    hfn = math.ceil((bits_min / u) * math.log(2))
    return bits, max(1, int(hfn))
