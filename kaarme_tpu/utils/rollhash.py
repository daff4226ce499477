"""NumPy golden model of the reference's dual rolling polynomial hash.

The reference updates, per input character, a forward hash
``h_f = (d * h_f + c) mod q`` (with a removal term for the outgoing
character) and a backward (reverse-complement) hash that rolls in O(1)
using the modular inverse of the base
(reference: source/hash_functions.cpp:102-208, base d = 5 at line 13).
The Bloom pipeline reduces the pair to a canonical "root hash"
``min(h_f, h_b)`` over q = 2^54
(reference: include/parallel_parser.hpp:2832, main.cpp:433-435).

The device path hashes materialized windows directly (ops/hashing.py) —
rolling recurrences buy nothing when all windows exist at once — but
this model is kept as a parity oracle: tests prove the rolling updates
match direct polynomial evaluation and that the root hash is
reverse-complement invariant, which is the property both designs rely
on.
"""

from __future__ import annotations

from .mathutils import modular_inverse, power_under_modulo

BASE_D = 5                    # reference: source/hash_functions.cpp:13
BF_MOD = 1 << 54              # reference: main.cpp:433


class RollingHasherDual:
    """Streaming dual hash over a window of length m, modulus q.

    ``update(in_code, out_code)`` slides the window one position;
    ``load(codes)`` (re)fills it from scratch
    (reference: source/hash_functions.cpp ``load_full_factory_canonical``).
    """

    def __init__(self, q: int, m: int, d: int = BASE_D):
        self.q = int(q)
        self.m = int(m)
        self.d = int(d)
        self.di = modular_inverse(self.d, self.q)
        self.dm1 = power_under_modulo(self.d, self.m - 1, self.q)  # d^(m-1)
        self.h_fwd = 0
        self.h_bwd = 0

    def reset(self):
        self.h_fwd = 0
        self.h_bwd = 0

    def load(self, codes):
        """Fill from a full window of m codes (0..3)."""
        assert len(codes) == self.m
        self.reset()
        for c in codes:
            # forward: append to the right
            self.h_fwd = (self.d * self.h_fwd + int(c)) % self.q
        for c in reversed(codes):
            # backward: the reverse complement read left-to-right
            self.h_bwd = (self.d * self.h_bwd + (3 - int(c))) % self.q

    def update(self, in_code: int, out_code: int):
        """Slide: drop ``out_code`` (leftmost), append ``in_code``."""
        q, d = self.q, self.d
        # forward: remove out * d^(m-1), shift, add in
        self.h_fwd = ((self.h_fwd - int(out_code) * self.dm1) * d + int(in_code)) % q
        # backward: the rc hash gains rc(in) at the HIGH end and drops
        # rc(out) at the low end -> divide by d (multiply by inverse)
        self.h_bwd = ((self.h_bwd - (3 - int(out_code))) * self.di
                      + (3 - int(in_code)) * self.dm1) % q

    def root(self) -> int:
        """Canonical (orientation-invariant) hash: min of the pair
        (reference: include/parallel_parser.hpp:2832)."""
        return min(self.h_fwd, self.h_bwd)


def direct_hash(codes, q: int, d: int = BASE_D) -> int:
    """Direct polynomial evaluation (the oracle for the rolling form)."""
    h = 0
    for c in codes:
        h = (d * h + int(c)) % q
    return h
