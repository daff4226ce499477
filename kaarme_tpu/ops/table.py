"""Batched open-addressing canonical k-mer count table in HBM.

Device replacement for the reference's CAS-based probe/insert loop
(``PointerHashTableCanonicalAV::process_kmer_MT``, reference:
source/kmer_hash_table.cpp:2207-2567) and for the plain spinlocked table
(reference: include/parallel_parser.hpp:465-551).  Per-k-mer CAS is
replaced by *batched probe rounds* over whole tiles:

  round r (all pending windows at once, pure gather/scatter):
    1. slot  = (h + r(r+1)/2) & (C-1)        (triangular probe, full cycle)
    2. gather (key words, count) at slot
    3. occupied & key==mine    -> scatter-add my amount; done
    4. empty                   -> optimistically scatter-set my key row,
                                  re-gather, and only if the stored row is
                                  mine scatter-add my amount ("CAS by
                                  write-then-verify"); losers re-probe
    5. otherwise               -> advance probe counter

Within-batch duplicates need no dedup: the first round's election winner
inserts, duplicates of the same key all "verify mine" (identical rows) or
match in a later round, and scatter-add accumulates them correctly.

Layout: keys ``(C, W)`` uint32 rows + counts ``(C,)`` int32, both HBM
resident; empty slot == count 0 (an inserted slot gets a positive count in
the same round it is claimed, so the invariant holds between rounds).

Capacity is a power of two; the hash (ops/hashing.py) provides uniform low
bits.  Unlike the reference, a full table does not ``exit(1)``
(reference: source/kmer_hash_table.cpp:2553-2556): unresolved windows are
reported via the returned ``pending`` mask and the pipeline grows the
table and retries (models/counter.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def make_table(capacity_log2: int, words: int):
    """Fresh table state: (keys (C, W) uint32, counts (C,) int32)."""
    c = 1 << capacity_log2
    return (
        jnp.zeros((c, words), jnp.uint32),
        jnp.zeros((c,), jnp.int32),
    )


def _tri(i):
    """Triangular probe offset i(i+1)/2 — a full cycle modulo 2^m."""
    iu = i.astype(jnp.uint32)
    return (iu * (iu + jnp.uint32(1))) >> jnp.uint32(1)


def insert(tkeys, counts, keys, valid, h, amount=None, max_probes: int = 64):
    """Insert/accumulate a batch of canonical k-mers into the table.

    Args:
      tkeys:  (C, W) uint32 table key rows.
      counts: (C,)  int32 table counts (0 == empty slot).
      keys:   tuple of W uint32 arrays [N] — packed canonical words.
      valid:  [N] bool — windows to insert.
      h:      [N] uint32 slot hash.
      amount: [N] int32 contribution per window (default 1).
      max_probes: static probe-round bound.

    Returns:
      (tkeys, counts, pending) — pending marks windows that did not land
      within ``max_probes`` rounds (table effectively full).
    """
    key_mat = jnp.stack(keys, axis=1)  # (N, W)
    n = key_mat.shape[0]
    c = tkeys.shape[0]
    mask = jnp.uint32(c - 1)
    if amount is None:
        amount = jnp.ones((n,), jnp.int32)

    def cond(state):
        r, pending, _, _, _ = state
        return jnp.logical_and(r < max_probes, jnp.any(pending))

    def body(state):
        r, pending, probe_i, tk, cn = state
        slot = ((h + _tri(probe_i)) & mask).astype(jnp.int32)

        g_cn = cn[slot]
        g_keys = tk[slot]
        occupied = g_cn > 0
        key_eq = jnp.all(g_keys == key_mat, axis=1)

        hit = pending & occupied & key_eq
        cn = cn.at[jnp.where(hit, slot, c)].add(amount, mode="drop")

        attempt = pending & ~occupied
        a_idx = jnp.where(attempt, slot, c)
        tk = tk.at[a_idx].set(key_mat, mode="drop")
        stored = tk[slot]
        mine = jnp.all(stored == key_mat, axis=1)
        success = attempt & mine
        cn = cn.at[jnp.where(success, slot, c)].add(amount, mode="drop")

        pending = pending & ~hit & ~success
        probe_i = probe_i + pending.astype(jnp.int32)
        return r + 1, pending, probe_i, tk, cn

    state = (
        jnp.int32(0),
        valid,
        # derive from a varying input so the carry type is stable under
        # shard_map (a constant init would be unvarying on axis 'd')
        jnp.zeros_like(h, jnp.int32),
        tkeys,
        counts,
    )
    _, pending, _, tkeys, counts = jax.lax.while_loop(cond, body, state)
    return tkeys, counts, pending


def lookup(tkeys, counts, keys, h, max_probes: int = 64):
    """Point lookup: count per key (0 if absent).

    Device analogue of the reference's ``find`` API
    (reference: source/kmer_hash_table.cpp:2675-2727).
    """
    key_mat = jnp.stack(keys, axis=1)
    n = key_mat.shape[0]
    c = tkeys.shape[0]
    mask = jnp.uint32(c - 1)

    def cond(state):
        r, pending, _, _ = state
        return jnp.logical_and(r < max_probes, jnp.any(pending))

    def body(state):
        r, pending, probe_i, out = state
        slot = ((h + _tri(probe_i)) & mask).astype(jnp.int32)
        g_cn = counts[slot]
        g_keys = tkeys[slot]
        occupied = g_cn > 0
        key_eq = jnp.all(g_keys == key_mat, axis=1)
        hit = pending & occupied & key_eq
        out = jnp.where(hit, g_cn, out)
        # empty slot terminates the probe chain: key is absent.
        pending = pending & occupied & ~key_eq
        probe_i = probe_i + pending.astype(jnp.int32)
        return r + 1, pending, probe_i, out

    state = (
        jnp.int32(0),
        jnp.ones_like(h, jnp.bool_),
        jnp.zeros_like(h, jnp.int32),
        jnp.zeros_like(h, jnp.int32),
    )
    _, _, _, out = jax.lax.while_loop(cond, body, state)
    return out


@partial(jax.jit, static_argnames=("k", "max_probes"))
def count_step(tkeys, counts, tiles, k: int, max_probes: int = 64):
    """One full device step: tiles of codes -> canonical windows -> insert.

    ``tiles`` is (B, T + k - 1) uint8; consecutive tiles carry a k-1 halo
    (the host reader replicates the reference's chunk-overlap backseek,
    reference: include/text_reader.h:206-213).

    Returns (tkeys, counts, n_overflow, pending) — pending is the exact
    per-window unresolved mask so a grow-and-retry only re-inserts what
    did not land.
    """
    from .windows import windows_with_hash

    keys, valid, h = windows_with_hash(tiles, k)
    tkeys, counts, pending = insert(tkeys, counts, keys, valid, h, max_probes=max_probes)
    return tkeys, counts, jnp.sum(pending.astype(jnp.int32)), pending
