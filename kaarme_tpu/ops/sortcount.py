"""Sort-based canonical k-mer counting (device side, JAX/XLA).

The flagship counting path.  The reference resolves each k-mer with a
CAS probe loop into a shared hash table (``process_kmer_MT``, reference:
source/kmer_hash_table.cpp:2207-2567).  Here counting is reformulated
as *sort + segment-reduce*, which XLA runs as bulk device passes:

  per batch of n windows (one fused jit step):
    1. unpack the 2-bit host stream (16 bases / uint32 word) + validity
       bitmap into per-position codes;
    2. materialize all canonical window keys at once (big-endian packed
       words, so string order == word-tuple order) — the vectorized
       replacement of the reference's rolling factory
       (source/kmer_factory.cpp:104-239);
    3. sort the n records by key words — invalid windows become all-ones
       sentinel rows and sink to the end;
    4. mark segment boundaries of equal keys and emit, at each segment's
       last row, the segment length (= in-batch count); all other rows
       carry count 0;
    5. append the sorted run to a persistent store (dynamic-update-slice
       at a host-tracked offset).

  when the store fills (or at finalize), ``compact`` sorts the store,
  segment-sums the counts of equal keys, and packs the distinct records
  into a sorted prefix — two sorts + cumulative ops, no scatters.

House rules for the device code in this file and ops/skm.py.  They were
adopted on an earlier backend and have NOT been measured on the GPU
(ROADMAP S7 re-derives them):

- ``jax.lax.optimization_barrier`` between pipeline stages, so XLA does
  not fuse elementwise work into the sort.
- NO boolean arrays at fusion boundaries.  All masks here are
  int32/uint32 in {0,1} or all-ones bitmasks, built with arithmetic
  (sign-shift, min/max, xor-nonzero).

Sentinel encoding: all-ones key words mark invalid/dead rows.  A real
canonical k-mer can never be all-ones: T^k is never canonical (its
reverse complement A^k is strictly smaller), and for k % 16 != 0 the
left-aligned trailing word has zero low bits.  Sentinels sort after
every real key, so no separate validity column is needed and sort
arity stays at W.

Counts are int32; output-time clipping (14-bit saturation in kaarme
mode, uint16 wrap in plain mode — reference: source/kmer.cpp:699-713,
source/kmer_hash_table.cpp:2001) happens host-side in the model layer.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.codec import words_per_kmer

SENTINEL = jnp.uint32(0xFFFFFFFF)

_B = jax.lax.optimization_barrier


def _nz(d):
    """int32 1 where uint32 d != 0 else 0 — without booleans."""
    return ((d | (jnp.uint32(0) - d)) >> jnp.uint32(31)).astype(jnp.int32)


# ---------------------------------------------------------------------------
# Host-side stream packing (NumPy fallback; C++ fast path in io/fastio.py)
# ---------------------------------------------------------------------------

def pack_stream_np(codes: np.ndarray):
    """Pack a {0..4} code stream for transfer: 16 bases per uint32 word
    (base i at bits 2*(i%16) of word i//16, little-endian within the
    word) plus a validity bitmap (bit set == invalid/reset position).

    Invalid positions carry code 0 in the packed words; the bitmap is the
    source of truth.  Returns (packed uint32, maskwords uint32).
    """
    codes = np.asarray(codes, np.uint8)
    n = codes.shape[0]
    bad = codes >= 4
    c = np.where(bad, np.uint8(0), codes).astype(np.uint32)
    npad16 = (-n) % 16
    if npad16:
        c = np.concatenate([c, np.zeros(npad16, np.uint32)])
    shifts = (np.arange(16, dtype=np.uint32) * 2).astype(np.uint32)
    packed = np.bitwise_or.reduce(c.reshape(-1, 16) << shifts[None, :], axis=1)

    b = bad.astype(np.uint32)
    npad32 = (-n) % 32
    if npad32:
        b = np.concatenate([b, np.zeros(npad32, np.uint32)])
    bshifts = np.arange(32, dtype=np.uint32)
    maskwords = np.bitwise_or.reduce(b.reshape(-1, 32) << bshifts[None, :], axis=1)
    return packed.astype(np.uint32), maskwords.astype(np.uint32)


def unpack_stream(packed, maskwords, n: int):
    """Device-side unpack: (codes uint32 [n], invalid int32 {0,1} [n])."""
    codes = unpack_codes(packed, maskwords, n)
    return codes & jnp.uint32(3), (codes >> jnp.uint32(2)).astype(jnp.int32)


def unpack_codes(packed, maskwords, n: int):
    """Device-side unpack to ONE uint32 [n] array: code 0..3, or 4 for
    invalid positions (bit 2 doubles as the invalid flag).  A single
    materialized array halves the HBM round-trip of the old
    (codes, invalid) pair — one full-array pass saved per batch.
    """
    x = jnp.stack(
        [(packed >> jnp.uint32(2 * j)) & jnp.uint32(3) for j in range(16)], axis=1
    ).reshape(-1)[:n]
    m = jnp.stack(
        [(maskwords >> jnp.uint32(j)) & jnp.uint32(1) for j in range(32)], axis=1
    ).reshape(-1)[:n]
    return x | (m << jnp.uint32(2))


# ---------------------------------------------------------------------------
# Fused batch step
# ---------------------------------------------------------------------------

def _canonical_keys_2d(shift, k: int):
    """Packed canonical key words from a shift-provider.

    ``shift(i)`` returns the 2D uint32 code plane at window offset i.
    Returns a list of W uint32 planes (big-endian packed, reference
    orientation semantics: lexicographic min of forward / reverse
    complement, ties -> forward — source/kmer_factory.cpp:219-233).
    """
    W = words_per_kmer(k)

    def pack(widx: int, rc: bool):
        acc = None
        for j in range(16):
            i = 16 * widx + j
            if acc is not None:
                acc = acc << jnp.uint32(2)
            if i < k:
                if rc:
                    plane = (jnp.uint32(3) - shift(k - 1 - i)) & jnp.uint32(3)
                else:
                    plane = shift(i)
                acc = plane if acc is None else (acc | plane)
        return acc

    fwd = [pack(w, rc=False) for w in range(W)]
    rcw = [pack(w, rc=True) for w in range(W)]

    # Single-pass lexicographic compare with an int32 carry: scanning
    # words last-to-first, the first differing word decides.  The
    # comparisons feed jnp.where directly (fused selects — safe); no i1
    # tensor survives the stage.
    c = jnp.zeros(fwd[0].shape, jnp.int32)
    for f, r in zip(reversed(fwd), reversed(rcw)):
        c = jnp.where(f < r, jnp.int32(-1), jnp.where(f > r, jnp.int32(1), c))
    return [jnp.where(c <= 0, f, r) for f, r in zip(fwd, rcw)]


def unpack_codes_sparse(packed, sep_idx, n: int):
    """Unpack 2-bit codes and mark invalid positions from a SPARSE index
    list instead of a dense bitmap: separators are ~1/151 of positions
    for read-delimited input, so shipping uint32 indices cuts transfer
    bytes by ~1/3 vs the n/8-byte dense mask.  ``sep_idx`` is padded
    with out-of-range values (dropped by the scatter)."""
    x = jnp.stack(
        [(packed >> jnp.uint32(2 * j)) & jnp.uint32(3) for j in range(16)], axis=1
    ).reshape(-1)[:n]
    return x.at[sep_idx].set(jnp.uint32(4), mode="drop", unique_indices=True)


def _pairrev32(x):
    """Reverse the sixteen 2-bit fields of each uint32 (bases stay
    intact; their order within the word flips), converting between the
    little-endian transfer packing and big-endian key-word packing."""
    m2, m4, m8 = jnp.uint32(0x33333333), jnp.uint32(0x0F0F0F0F), jnp.uint32(0x00FF00FF)
    x = ((x & m2) << jnp.uint32(2)) | ((x >> jnp.uint32(2)) & m2)
    x = ((x & m4) << jnp.uint32(4)) | ((x >> jnp.uint32(4)) & m4)
    x = ((x & m8) << jnp.uint32(8)) | ((x >> jnp.uint32(8)) & m8)
    return (x << jnp.uint32(16)) | (x >> jnp.uint32(16))


def invalid_from_sparse(sep_idx, L: int):
    """int32 {0,1} per-position invalid vector from a sparse separator
    index list (out-of-range pad entries drop)."""
    return jnp.zeros((L,), jnp.int32).at[sep_idx].set(
        1, mode="drop", unique_indices=True)


def invalid_from_dense(maskwords, L: int):
    """int32 {0,1} per-position invalid vector from the dense bitmap."""
    m = jnp.stack(
        [(maskwords >> jnp.uint32(j)) & jnp.uint32(1) for j in range(32)], axis=1
    ).reshape(-1)[:L]
    return m.astype(jnp.int32)


def _sentinel_mask_from_invalid(invalid, k: int, n: int):
    """uint32 [n] all-ones where window t contains an invalid position
    (next-invalid-at-or-after t is < t + k), else 0 — the same
    arithmetic sign-extend formulation as window_keys_from_codes."""
    L = invalid.shape[0]
    idx_l = jax.lax.broadcasted_iota(jnp.int32, (L,), 0)
    nii = jax.lax.cummin(
        idx_l * invalid + (1 - invalid) * jnp.int32(1 << 30), reverse=True
    )
    nii = _B(nii)
    d = jax.lax.slice(nii, (0,), (n,)) - jax.lax.broadcasted_iota(jnp.int32, (n,), 0) - k
    return jax.lax.bitcast_convert_type(d >> 31, jnp.uint32)


def window_keys_packed(packed, invalid, k: int, n: int):
    """Canonical window keys straight from the 2-bit PACKED stream —
    no per-position code array is ever materialized.

    Per key word this is two whole-word shift-ors instead of sixteen
    per-character shift-or-accumulate steps (the reference's rolling
    factory counterpart — source/kmer_factory.cpp:104-239 — updates one
    character at a time; the code formulation replicates that
    per-character structure across planes).  Identities used:

    - forward key word w of window j covers bases j+16w .. j+16w+15 in
      big-endian order: with ``pbe`` = the packed stream's words with
      their sixteen 2-bit fields reversed (one cheap O(L/16) pass), it
      is ``(pbe[q] << 2p) | (pbe[q+1] >> (32-2p))`` at q, p = divmod
      (j + 16w, 16);
    - the reverse-complement key word w covers bases j+k-1-16w down to
      j+k-16(w+1), complemented: reading those 16 bases in DESCENDING
      order from a little-endian extraction gives big-endian packing
      for free, so it is ``~((pk[q2] >> 2p2) | (pk[q2+1] << (32-2p2)))``
      at q2, p2 = divmod(j + k - 16*(w+1), 16) on the UNreversed words
      (complement 3-c == bitwise NOT per 2-bit field).

    Grouping windows by phase j % 16 makes q/q2 affine in the group
    index with static offsets, so every word is a shifted slice + two
    shifts + or over n/16-length arrays.  Trailing-word low bits are
    masked (left-aligned contract); reads beyond either stream end only
    ever land in those masked bits.

    Args: packed uint32 [>= ceil((n+k-1)/16)] little-endian 2-bit codes
    (invalid positions' code bits are DON'T-CARE — the mask is the
    source of truth, matching pack_stream_np); invalid int32 {0,1}
    [n + k - 1]; n must be a multiple of 16.  Returns W uint32 [n]
    columns, bit-identical to window_keys_from_codes.
    """
    if n % 16:
        raise ValueError("window_keys_packed requires n % 16 == 0")
    W = words_per_kmer(k)
    r = k % 16
    topmask = jnp.uint32(0xFFFFFFFF) if r == 0 else \
        jnp.uint32(((1 << (2 * r)) - 1) << (32 - 2 * r))
    M = n // 16
    need = M + W + 1            # highest word index used is M + W
    pad = max(0, need - packed.shape[0])
    pk = jnp.concatenate([
        jnp.zeros((1,), jnp.uint32),          # front pad: rc q2 reaches -1
        packed,
        jnp.zeros((pad,), jnp.uint32),
    ])                                        # pk[i] = packed[i - 1]
    pk = _B(pk)
    pbe = _pairrev32(pk)

    def sl(arr, s0: int):
        return jax.lax.slice(arr, (s0 + 1,), (s0 + 1 + M,))

    # canonical select per phase, all on (M,) arrays
    sel = [None] * 16  # sel[p][w]
    for p in range(16):
        fwd, rcw = [], []
        for w in range(W):
            a, b = sl(pbe, w), sl(pbe, w + 1)
            f = a if p == 0 else \
                ((a << jnp.uint32(2 * p)) | (b >> jnp.uint32(32 - 2 * p)))
            e = p + k - 16 * (w + 1)
            qoff, p2 = e // 16, e % 16
            c, d = sl(pk, qoff), sl(pk, qoff + 1)
            z = c if p2 == 0 else \
                ((c >> jnp.uint32(2 * p2)) | (d << jnp.uint32(32 - 2 * p2)))
            g = ~z
            if w == W - 1:
                f, g = f & topmask, g & topmask
            fwd.append(f)
            rcw.append(g)
        carry = jnp.zeros((M,), jnp.int32)
        for f, g in zip(reversed(fwd), reversed(rcw)):
            carry = jnp.where(f < g, jnp.int32(-1),
                              jnp.where(f > g, jnp.int32(1), carry))
        sel[p] = [jnp.where(carry <= 0, f, g) for f, g in zip(fwd, rcw)]

    smask = _sentinel_mask_from_invalid(invalid, k, n)
    out = []
    for w in range(W):
        col = jnp.stack([sel[p][w] for p in range(16)], axis=1).reshape(-1)
        out.append(col | smask)
    # Barrier-fence the finished keys so XLA cannot fuse the whole
    # phase-grouped shift/select network INTO the consumer sort (the
    # module-docstring rule)
    return _B(tuple(out))


def window_keys_from_codes(codes, k: int, n: int, rows: int):
    """Canonical window keys from an unpacked code array (length
    n + k - 1, values 0..3 valid / bit 2 set = invalid).  See
    ``window_keys`` for the contract; split out so callers can choose
    the unpack (dense bitmap vs sparse separator list)."""
    L = n + k - 1
    cols = n // rows
    codes = _B(codes)

    def shift(i: int):
        plane = jax.lax.slice(codes, (i,), (i + n,)).reshape(rows, cols)
        return plane & jnp.uint32(3)

    keys = list(_B(tuple(_canonical_keys_2d(shift, k))))

    invalid = (codes >> jnp.uint32(2)).astype(jnp.int32)
    idx_l = jax.lax.broadcasted_iota(jnp.int32, (L,), 0)
    nii = jax.lax.cummin(
        idx_l * invalid + (1 - invalid) * jnp.int32(1 << 30), reverse=True
    )
    nii = _B(nii)
    d = jax.lax.slice(nii, (0,), (n,)) - jax.lax.broadcasted_iota(jnp.int32, (n,), 0) - k
    smask = jax.lax.bitcast_convert_type(d >> 31, jnp.uint32)  # all-ones iff bad

    return tuple(x.reshape(-1) | smask for x in keys)


def window_keys(packed, maskwords, k: int, n: int, rows: int):
    """One batch: packed stream -> n canonical window keys (UNSORTED).

    Args:
      packed:    uint32 [ceil((n+k-1)/16)] 2-bit packed codes.
      maskwords: uint32 [ceil((n+k-1)/32)] invalid bitmap.
      k:         window length (static).
      n:         number of window positions (static, multiple of ``rows``).
      rows:      2D working-layout row count (static).

    Returns a tuple of W uint32 [n] arrays; invalid windows are sentinel
    (all-ones) rows.  No per-batch sort/count happens here: the merge
    sorts everything anyway, so batch-local ordering would be pure waste.

    Window validity: window t is bad iff the next invalid position at
    or after t is < t + k.  next-invalid via reverse cummin; the bad
    mask becomes an all-ones bitmask through an arithmetic sign-extend
    (no boolean tensors).  invalid flag = code bit 2.
    """
    codes = unpack_codes(packed, maskwords, n + k - 1)
    return window_keys_from_codes(codes, k, n, rows)


def _clamp_count(c):
    """Modular clamp: c > 2^20 -> 2^20 + (c mod 2^20).  Both output
    contracts survive (14-bit saturation needs only c >= 16383 —
    reference: source/kmer.cpp:699-713 — and uint16 wrap needs only
    c mod 65536, and 65536 | 2^20).  Applied to every stored segment
    sum, so stored counts are < 2^21 everywhere; that bound is what
    makes the count-embedding eligibility gate in the model layer and
    the wrapped-uint32 segment sums below sound."""
    big = 1 << 20
    if c.dtype == jnp.uint32:
        return jnp.where(c > jnp.uint32(big),
                         jnp.uint32(big) + (c & jnp.uint32(big - 1)), c)
    return jnp.where(c > jnp.int32(big), jnp.int32(big) + (c & jnp.int32(big - 1)), c)


def _is_sentinel_i32(keys):
    """int32 1 where the row is a sentinel (all key words all-ones)."""
    acc = keys[0]
    for x in keys[1:]:
        acc = acc & x
    return 1 - _nz(acc ^ SENTINEL)


def _segment_marks(s_keys):
    """(idx, first, last) int32 {0,1} row masks of equal-key segments of
    sorted keys — all-integer, barrier-fenced (see module docstring)."""
    n = s_keys[0].shape[0]
    idx = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    neq = _nz(s_keys[0] ^ jnp.roll(s_keys[0], 1))
    for x in s_keys[1:]:
        neq = jnp.maximum(neq, _nz(x ^ jnp.roll(x, 1)))
    neq = _B(neq)
    first = jnp.maximum(neq, 1 - jnp.minimum(idx, 1))        # row 0 is first
    last = jnp.roll(first, -1)
    last = jnp.maximum(last, 1 - jnp.minimum(n - 1 - idx, 1))  # row n-1 is last
    first, last = _B((first, last))
    return idx, first, last


def _boundary_counts(s_keys):
    """Per-record count of its segment, emitted at the segment's LAST row
    (0 elsewhere); sentinel records count 0.  Inputs sorted.  Counts are
    clamped (see _clamp_count) so the stored-count invariant (< 2^21)
    holds even for a single key filling a whole merge."""
    idx, first, last = _segment_marks(s_keys)
    start = jax.lax.cummax(first * idx)
    start = _B(start)
    alive = last * (1 - _is_sentinel_i32(s_keys))
    return alive * _clamp_count(idx - start + 1)


# ---------------------------------------------------------------------------
# Store: append + compact
# ---------------------------------------------------------------------------

def make_store(cap: int, words: int):
    """Store columns: W uint32 key columns + 1 int32 count column.
    Dead rows are SENTINELS (all-ones keys, count 0): unlike zero-key
    padding they can never alias a real key's segment, which the
    cumsum-free embedded compact relies on (a count-0 row inside a real
    segment would inflate its length-based count)."""
    return tuple(
        jnp.full((cap,), SENTINEL, jnp.uint32) for _ in range(words)
    ) + (jnp.zeros((cap,), jnp.int32),)


def dead_fill(shape, dtype):
    """Padding rows for store columns: sentinel keys, zero counts."""
    if dtype == jnp.int32 or dtype == np.int32:
        return jnp.zeros(shape, jnp.int32)
    return jnp.full(shape, SENTINEL, jnp.uint32)


def compact(store, clamped: bool = False):
    """Merge duplicate keys and pack distinct records into a sorted
    prefix.  Returns (store, n_distinct).

    Default path: segment sums run in WRAPPED uint32 — the global cumsum
    may overflow 2^32, but each segment's true sum is < 2^32 (structural
    invariant: every STREAMING caller feeds at most a few clamped
    (< 2^21) rows per key plus unit-count rows, and one merge holds
    < 2^30 rows), so the uint32 difference (csum_at_last -
    csum_before_first) is exact.  The per-segment base comes from ONE
    gather at the segment start index (the old monotone-cummax
    propagation required a nondecreasing csum, which wrapping breaks).

    ``clamped=True``: for callers that CANNOT bound rows-per-segment —
    the skm finalize expansion feeds one clamped (< 2^21) row per
    distinct run containing a k-mer, so a low-complexity k-mer at scale
    can exceed 2^32 true mass and silently wrap.  The segment sum then
    runs as a log-shift segmented inclusive scan with the modular clamp
    applied at every step: clamp commutes with addition
    (clamp(a+b) == clamp(clamp(a)+b) — both output contracts live in
    the preserved mod-2^20 residue + the saturating >=2^20 indicator),
    so intermediates stay < 2^22 and the final clamped total is exact
    for ANY segment length.
    """
    *keys, cnt = store

    order = tuple(keys) + (cnt,)
    s = jax.lax.sort(order, num_keys=len(keys))
    s = _B(s)
    s_keys, s_cnt = list(s[:-1]), s[-1]

    with jax.named_scope("compact"):
        # defensive input clamp (all producers clamp already): keeps every
        # row < 2^21 so the per-segment-sum bound above holds
        s_cnt = _clamp_count(s_cnt)

        idx, first, last = _segment_marks(s_keys)
        start = jax.lax.cummax(first * idx)
        start = _B(start)
        alive = last * (1 - _is_sentinel_i32(s_keys))

        if clamped:
            n = s_cnt.shape[0]
            val = s_cnt.astype(jnp.uint32)
            sh = 1
            while sh < n:
                prev = jnp.roll(val, sh)
                pstart = jnp.roll(start, sh)
                # row i-sh exists (i >= sh) and lies in the same segment
                ok = jnp.minimum(jnp.maximum(idx - (sh - 1), 0), 1) \
                    * (1 - _nz(jax.lax.bitcast_convert_type(
                        start ^ pstart, jnp.uint32)))
                val = _clamp_count(val + ok.astype(jnp.uint32) * prev)
                val = _B(val)
                sh <<= 1
            seg = alive * val.astype(jnp.int32)
        else:
            csum = jnp.cumsum(s_cnt.astype(jnp.uint32))  # wraps mod 2^32 — fine
            csum = _B(csum)
            # base = csum just before the segment start (0 for the first segment)
            base = jnp.take(csum, jnp.maximum(start - 1, 0)) \
                * jnp.minimum(start, 1).astype(jnp.uint32)
            seg = alive * _clamp_count(csum - base).astype(jnp.int32)

        # pack alive records (seg > 0) to the front, preserving key order: a
        # STABLE sort on the 1-bit dead flag is a stable partition — much
        # cheaper than re-sorting the full W-word keys
        dead = (jnp.uint32(1) - jnp.minimum(seg, 1).astype(jnp.uint32))
        order2 = (dead,) + tuple(s_keys) + (seg,)
        s2 = jax.lax.sort(order2, num_keys=1, is_stable=True)
        s2 = _B(s2)
        out_keys, out_cnt = list(s2[1:-1]), s2[-1]
        n_distinct = jnp.sum(jnp.minimum(out_cnt, 1))
    return tuple(out_keys) + (out_cnt,), n_distinct


# ---------------------------------------------------------------------------
# Jitted entry points
# ---------------------------------------------------------------------------

def embed_bits(k: int) -> int:
    """Free low bits in the (left-aligned) trailing key word."""
    r = k % 16
    return 2 * (16 - r) if r else 0


WINKEYS = ("codes", "packed")   # window-key extraction formulations


def check_winkeys(mode: str) -> str:
    """Validate a config ``winkeys`` value (see _keys_from_chunk)."""
    if mode not in WINKEYS:
        raise ValueError(f"winkeys must be one of {WINKEYS}, got {mode!r}")
    return mode


def next_store_size(x: int, coarse: bool = False) -> int:
    """Smallest {2^m, 3*2^m} (m >= 12) value >= x — the distinct-store
    size ladder (bounded jit variants).

    ``coarse``: powers of two ONLY above 2^22 — used by the live-prefix
    slicing ladder on growing stores, where every ladder value is a
    fresh merge-program compile, so fewer sizes trade sort mass for
    compiles (the balance is unmeasured on the GPU — ROADMAP S7)."""
    x = max(int(x), 1 << 12)
    p = 1 << (x - 1).bit_length()
    if coarse and x > (1 << 22):
        return p
    return 3 * p // 4 if 3 * p // 4 >= x else p


# ---------------------------------------------------------------------------
# Fused superstep: one dispatch per superbatch
# ---------------------------------------------------------------------------
# The superstep fuses unpack -> canonical windows -> merge-with-prefix
# into ONE compiled call, so each superbatch costs one host dispatch.
# Transfers are issued by the model layer while the previous superstep
# runs.

def _chunk_views(packed, sep, wstart, srow, k: int, n: int, dense: bool):
    """Slice one superstep's inputs out of a device-resident transfer
    chunk.  The model layer may ship SEVERAL superbatches per copy
    (``transfer_group``): ``packed`` may hold G superbatches of
    ``nwords`` words each
    (wstart = g*nwords, traced so one program serves every g), and
    ``sep`` is either a (G, budget) row matrix of per-superstep sparse
    separator indices (relative to the superstep's span) or the
    concatenated dense bitmaps.  Exact single-superbatch arrays with
    wstart = srow = 0 pass through unchanged (static no-op slice)."""
    need = n + k - 1
    nwords = (need + 15) // 16
    mwords = (need + 31) // 32
    if packed.shape[0] != nwords:
        packed = jax.lax.dynamic_slice(packed, (wstart,), (nwords,))
    if dense:
        if sep.shape[0] != mwords:
            sep = jax.lax.dynamic_slice(
                sep, (srow * jnp.int32(mwords),), (mwords,))
    elif sep.ndim == 2:
        sep = jax.lax.dynamic_slice(sep, (srow, 0), (1, sep.shape[1]))[0]
    return packed, sep


@partial(jax.jit, static_argnames=("k", "n", "rows", "ebits", "dense",
                                   "hfn", "winkeys"))
def superstep_embedded(packed, sep, prefix, wstart=0, srow=0, *,
                       k: int, n: int, rows: int,
                       ebits: int, dense: bool = False,
                       bloom=None, hfn: int = 0, winkeys: str = "codes"):
    """packed stream (+ separator info) + distinct prefix ->
    (new prefix columns sliced to the prefix capacity, nd) where nd is
    a (2,) int32 array [nd_exact, nd_used]: exact distinct count, and
    the number of prefix rows occupied.  The compaction packs densely,
    so the two are equal; consumers still treat count-0 rows as dead.

    ``sep`` is a sparse uint32 separator-index list (default) or, with
    ``dense=True``, the uint32 invalid bitmap (for inputs with > 1/32
    separator density, where the sparse list stops saving bytes).

    Embedded-count formulation (ebits >= 21): the count travels in the
    trailing key word's low bits, so the merge is one W-column sort +
    one compaction (_compact_embedded).  The prefix is NOT donated: if
    nd_used overflows the capacity the caller re-pads the (still live)
    old prefix and retries with a larger capacity.
    """
    w = len(prefix) - 1
    cap = prefix[0].shape[0]
    packed, sep = _chunk_views(packed, sep, wstart, srow, k, n, dense)
    keys = _keys_from_chunk(packed, sep, dense, k, n, rows, winkeys)
    if bloom is not None:
        miss = _bloom_miss_mask(bloom, keys, hfn)
        keys = tuple(x | miss for x in keys)

    cols = [jnp.concatenate([prefix[i], keys[i]]) for i in range(w - 1)]
    last = jnp.concatenate(
        [prefix[w - 1] | prefix[-1].astype(jnp.uint32), keys[w - 1] | jnp.uint32(1)]
    )
    store, nd = _compact_embedded(cols + [last], ebits)
    return tuple(c[:cap] for c in store), jnp.stack([nd, nd])


def _keys_from_chunk(packed, sep, dense: bool, k: int, n: int, rows: int,
                     winkeys: str):
    """Shared superstep stage: transfer chunk -> canonical window keys.

    winkeys selects the extraction formulation (bit-identical):
      "codes"  — unpack a per-position code array, then the rolling-
                 factory-shaped planes (window_keys_from_codes);
      "packed" — direct shift-or extraction from the packed words
                 (window_keys_packed; no code array).  Needs n % 16 == 0
                 and falls back to "codes" otherwise.
    """
    L = n + k - 1
    if winkeys == "packed" and n % 16 == 0:
        inv = invalid_from_dense(sep, L) if dense \
            else invalid_from_sparse(sep, L)
        return window_keys_packed(packed, inv, k, n)
    codes = unpack_codes(packed, sep, L) if dense \
        else unpack_codes_sparse(packed, sep, L)
    return window_keys_from_codes(codes, k, n, rows)


# ---------------------------------------------------------------------------
# Two-stage Bloom prefilter on the sort backend
# ---------------------------------------------------------------------------
# The reference's -b mode is a two-pass pipeline: pass 1 streams the
# input through BF1/BF2, pass 2 counts only k-mers present in BF2
# (reference: main.cpp:395-510).  On the sort backend the filter ORs an
# all-ones miss mask into failing windows' key words, turning them into
# the established sentinel rows BEFORE the sort — singletons never enter
# the merge, cutting merge mass exactly like the reference's table-size
# reduction.

def _bloom_miss_mask(bf2, keys, hfn: int):
    """uint32 all-ones where the key's hfn Bloom bits are NOT all set
    (arithmetic, ONE gather per key — blocked layout, ops/bloom.py)."""
    from .bloom import contains_i32
    from .hashing import hash_words64

    r1, r2 = hash_words64(keys)
    hit = contains_i32(bf2, r1, r2, hfn)
    return jax.lax.bitcast_convert_type((hit - 1) >> 31, jnp.uint32)


@partial(jax.jit, static_argnames=("k", "n", "rows", "dense", "hfn",
                                   "winkeys"), donate_argnums=(0, 1))
def bloom_pass1_superstep(bf1, bf2, packed, sep, wstart=0, srow=0, *,
                          k: int, n: int, rows: int, dense: bool = False,
                          hfn: int = 4, winkeys: str = "codes"):
    """Pass-1 superstep: unpack -> window keys -> BF1/BF2 insertion.
    Same (packed, sep, wstart, srow) transfer contract as the counting
    supersteps so the model layer's prep/transfer machinery is reused.
    Returns (bf1, bf2, new_in_first, new_in_second)."""
    from .bloom import insert_batch
    from .hashing import hash_words64

    packed, sep = _chunk_views(packed, sep, wstart, srow, k, n, dense)
    keys = _keys_from_chunk(packed, sep, dense, k, n, rows, winkeys)
    # invalid windows are all-ones on EVERY word (a real canonical key
    # can have all-ones words, but never all of them — module docstring)
    andw = keys[0]
    for x in keys[1:]:
        andw = andw & x
    valid = andw != SENTINEL
    r1, r2 = hash_words64(keys)
    return insert_batch(bf1, bf2, r1, r2, valid, hfn)


@partial(jax.jit, static_argnames=("k", "n", "rows", "dense", "hfn",
                                   "winkeys"))
def superstep_plain(packed, sep, prefix, wstart=0, srow=0, *,
                    k: int, n: int, rows: int, dense: bool = False,
                    bloom=None, hfn: int = 0, winkeys: str = "codes"):
    """superstep for k values without >= 21 free trailing-word bits:
    counts ride a separate int32 column through the merge.  Same
    (prefix, [nd_exact, nd_used]) contract as superstep_embedded."""
    w = len(prefix) - 1
    cap = prefix[0].shape[0]
    packed, sep = _chunk_views(packed, sep, wstart, srow, k, n, dense)
    keys = _keys_from_chunk(packed, sep, dense, k, n, rows, winkeys)
    if bloom is not None:
        miss = _bloom_miss_mask(bloom, keys, hfn)
        keys = tuple(x | miss for x in keys)

    cols = [jnp.concatenate([prefix[i], keys[i]]) for i in range(w)]
    cnt = jnp.concatenate([prefix[-1], jnp.ones((n,), jnp.int32)])
    store, nd = compact(tuple(cols) + (cnt,))
    return tuple(c[:cap] for c in store), jnp.stack([nd, nd])


def _compact_embedded(cols, ebits: int):
    """Compact W columns whose last column carries the count in its low
    ``ebits`` bits (the trailing key word is left-aligned, so for
    k % 16 in {1,2,3} there are >= 26 spare bits — enough for the count
    clamp plus a full merge's row count).  Embedding removes the count
    payload from both sorts: arity W instead of W+1, and the stable
    partition carries W+1 columns instead of W+2.

    Rows with all-ones in every column are sentinels.  Returns (store
    columns with counts split back out, n_distinct) in the standard
    store format.

    Segment sums are CUMSUM-FREE: callers guarantee at most ONE
    non-unit-count row per real-key segment (the compacted prefix has
    one row per key; run rows carry count 1), and because the count
    lives in the LOW bits of the last sort key, rows within an
    equal-key segment order by count ascending — so the segment's last
    row holds that one non-unit count.  The segment sum is then exactly
    c_last + (len - 1), all in small int32 (c_last < 2^21 by the stored
    clamp invariant, len <= rows-per-merge < 2^28).  This drops the
    cumsum + roll + base passes from the hot merge AND removes the
    int32-overflow hazard the cumsum formulation had.
    """
    w = len(cols)
    cmask = jnp.uint32((1 << ebits) - 1)

    s = jax.lax.sort(tuple(cols), num_keys=w)
    s = _B(s)
    with jax.named_scope("compact"):
        s_keys = list(s[:-1])
        s_cnt = (s[-1] & cmask).astype(jnp.int32)
        s_last = s[-1] & ~cmask

        marks_keys = s_keys + [s_last]
        idx, first, last = _segment_marks(marks_keys)

        start = jax.lax.cummax(first * idx)
        start = _B(start)
        # sentinel: all words all-ones once the count bits are ignored
        acc = s_last | cmask
        for x in s_keys:
            acc = acc & x
        alive = last * _nz(acc ^ SENTINEL)
        seg = alive * _clamp_count(s_cnt + (idx - start))

        # stable partition on the dead flag; dead rows become sentinels
        smask = jax.lax.bitcast_convert_type((seg - 1) >> 31, jnp.uint32)
        dead = (smask & jnp.uint32(1))
        out_cols = [x | smask for x in s_keys] + [(s_last | seg.astype(jnp.uint32)) | smask]
        s2 = jax.lax.sort((dead,) + tuple(out_cols), num_keys=1, is_stable=True)
        s2 = _B(s2)
        d2, out = s2[0], list(s2[1:])
        alive2 = (jnp.int32(1) - d2.astype(jnp.int32))
        out_cnt = (out[-1] & cmask).astype(jnp.int32) * alive2
        # split the count back out; dead rows revert to all-ones sentinels
        out_last = (out[-1] & ~cmask) | (jnp.uint32(0) - d2)
        n_distinct = jnp.sum(alive2)
    return tuple(out[:-1]) + (out_last, out_cnt), n_distinct


def lookup_sorted(keys_np: np.ndarray, cnt_np: np.ndarray, queries: np.ndarray):
    """Host-side binary search over the compacted store prefix.

    keys_np: (N, W) uint32 rows sorted lexicographically; queries: (Q, W)
    uint32.  Returns int64 counts (0 where absent).  The host analogue of
    the reference's ``find`` (source/kmer_hash_table.cpp:2675-2727).

    Per query: narrow an index range column by column (each column is
    sorted within the range fixed by the previous columns).
    """
    q = queries.shape[0]
    out = np.zeros(q, np.int64)
    n = keys_np.shape[0]
    if n == 0:
        return out
    w = keys_np.shape[1]
    for i in range(q):
        lo, hi = 0, n
        for j in range(w):
            col = keys_np[lo:hi, j]
            v = queries[i, j]
            lo, hi = lo + np.searchsorted(col, v, "left"), lo + np.searchsorted(col, v, "right")
            if lo == hi:
                break
        if lo < hi:
            out[i] = int(cnt_np[lo])
    return out
