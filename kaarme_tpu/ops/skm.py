"""Super-k-mer (minimizer-run) counting pipeline.

The sort-based flagship (ops/sortcount.py) pays one sorted W-column row
PER WINDOW.  The input stream, however, is massively redundant:
at sequencing coverage c every genomic locus appears in ~c reads, so
~c copies of every window ride the stream.  The reference exploits the
*intra-read* redundancy with its one-character-and-pointer chain
(reference: source/kmer_hash_table.cpp:2769-3068 — consecutive windows
overlap k-1 characters); this module exploits the *inter-read*
redundancy with bulk device passes:

  1. segment the window stream into minimizer runs: maximal spans of
     consecutive windows sharing the same m-mer minimizer (m = 16, one
     u32 word), length-capped at Lmax = 16.  Run boundaries are
     CONTENT-determined, so reads covering the same locus produce
     byte-identical runs;
  2. pack each run into a fixed-width row: Wc = ceil((Lmax+k-1)/16)
     content words (the run's ell+k-1 bases, big-endian) plus a meta
     word carrying (ell-1) << 26 | occurrence count.  Packing routes
     each 512-window tile's run starts into S slots with a one-hot
     matmul (pack_slots; ROADMAP S4 weighs a dense cumsum + scatter
     layout against it on the GPU);
  3. sort + segment-reduce the ~n/12 run rows (not n window rows) and
     merge them into a persistent run store — the existing
     embedded-count compaction (sortcount._compact_embedded) applies
     verbatim with ebits = 26;
  4. at finalize, expand the DISTINCT runs (≈ genome mass, not stream
     mass) into canonical window keys with their run counts and
     segment-reduce those into the standard key store.

Exactness does not depend on minimizer behavior: segmentation
partitions the valid windows of the stream, every run occurrence
expands back to exactly its windows, and counts add up (the 2^20
modular count clamp commutes with summation — see _clamp_count).
Minimizers only decide how well identical spans dedup.

All device code follows the house performance rules (module docstring
of ops/sortcount.py): no boolean tensors at fusion boundaries,
optimization barriers between stages, masks via sign-shift arithmetic.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.codec import words_per_kmer
from . import sortcount
from .sortcount import SENTINEL, _B, _nz, _pairrev32

M = 16          # minimizer m-mer length (one u32 word)
LMAX = 16       # run length cap (windows); keeps ell in 4 meta bits
EBITS = 26      # meta layout: (ell-1) << 26 | count  (counts clamped < 2^21)
TILE = 512      # windows per one-hot packing tile (C)


def content_words(k: int) -> int:
    """Wc: u32 words covering a maximal run's Lmax + k - 1 bases."""
    return (LMAX + k - 1 + 15) // 16


def store_words(k: int) -> int:
    """Run-store key columns: Wc content words + the meta word."""
    return content_words(k) + 1


def supported(k: int) -> bool:
    return k >= M


# ---------------------------------------------------------------------------
# Segmentation (device)
# ---------------------------------------------------------------------------

def _sliding_min(x, w: int):
    """y[i] = min(x[i..i+w-1]) by log-shift; len(y) = len(x) - w + 1."""
    y, s = x, 1
    while s < w:
        step = min(s, w - s)
        y = jnp.minimum(jax.lax.slice(y, (0,), (y.shape[0] - step,)),
                        jax.lax.slice(y, (step,), (y.shape[0],)))
        s += step
    return y


def _mwords_packed(pk, n_words: int):
    """Big-endian 16-base words at every position straight from the
    2-bit packed stream: raw[i] packs bases i..i+15.

    Uses the repeat-plus-variable-shift formulation (~5 elementwise
    passes) instead of the 16-slice shift-or accumulation (~32 passes),
    in case XLA does not fuse the chain: with pbe = packed
    words with their sixteen 2-bit fields reversed,
    raw[i] = (pbe[i//16] << 2*(i%16)) | (pbe[i//16 + 1] >> (32 - 2*(i%16))).

    pk must cover word index n_words//16 + 1 (caller pads with zeros;
    invalid positions' code bits are zero by the pack contract, and
    every read of them lands in masked or overridden results).
    """
    pbe = _pairrev32(pk)
    nw = pbe.shape[0]
    rep = jnp.broadcast_to(pbe[:, None], (nw, 16)).reshape(-1)
    a = jax.lax.slice(rep, (0,), (n_words,))
    bx = jax.lax.slice(rep, (16,), (16 + n_words,))
    s = jnp.broadcast_to((jnp.arange(16, dtype=jnp.uint32) * 2)[None, :],
                         (nw, 16)).reshape(-1)[:n_words]
    # (bx >> (31-s)) >> 1 == bx >> (32-s) without the s=0 UB shift
    return (a << s) | ((bx >> (jnp.uint32(31) - s)) >> jnp.uint32(1))


def segment_runs(pk, inval, k: int, n: int):
    """Window-stream segmentation into minimizer runs.

    pk: uint32 packed 2-bit codes covering word (n + 16*(Wc-1))//16 + 1
    (zero-padded); inval: int32 {0,1} [n + k - 1] invalid positions.
    Returns per-window arrays (all int32/uint32, no booleans):
      b        {0,1} run-start flag (every window belongs to the run of
               the closest start at or before it),
      ell      run length in windows, valid at start positions (<= LMAX
               for live runs),
      valid    {0,1} window validity,
      raw      uint32 [n + 16*(Wc-1)] big-endian content words at every
               position (invalid/past-end positions contribute code 0 —
               they are only ever read inside masked content regions).
    """
    w = k - M + 1
    Wc = content_words(k)
    idx = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)

    n_raw = n + 16 * (Wc - 1)
    raw = _mwords_packed(pk, n_raw)
    raw = _B(raw)

    # minimizer per window: min over the w m-words inside the window.
    # Partially-invalid m-words only occur inside invalid windows, whose
    # minimizer is overridden below — no separate sentinel pass needed.
    minv = _sliding_min(jax.lax.slice(raw, (0,), (n + w - 1,)), w)

    # window validity via the established next-invalid formulation
    smask = sortcount._sentinel_mask_from_invalid(inval, k, n)
    valid = (jnp.int32(1) - (smask & jnp.uint32(1)).astype(jnp.int32))
    minv = minv | (jnp.uint32(0) - (1 - valid).astype(jnp.uint32))
    minv, valid = _B((minv, valid))

    # run starts: minimizer change, validity change, or stream start
    neq = jnp.maximum(_nz(minv ^ jnp.roll(minv, 1)),
                      (valid ^ jnp.roll(valid, 1)))
    true_b = jnp.maximum(neq, 1 - jnp.minimum(idx, 1))
    true_b = _B(true_b)

    # content-anchored length cap: force a start every LMAX windows past
    # the last true start (suppressed inside invalid runs — they are
    # dropped whole, and capping would only multiply dead rows)
    pos1 = idx - jax.lax.cummax(true_b * idx)
    force = valid * jnp.minimum(pos1, 1) * \
        (1 - jnp.minimum(pos1 & jnp.int32(LMAX - 1), 1))
    b = jnp.maximum(true_b, force)
    b = _B(b)

    # run length at start positions: distance to the next start
    BIG = 1 << 30
    nxt = jax.lax.cummin(idx * b + (1 - b) * jnp.int32(BIG), reverse=True)
    nxt = jnp.concatenate([jax.lax.slice(nxt, (1,), (n,)),
                           jnp.full((1,), BIG, jnp.int32)])
    ell = jnp.clip(jnp.minimum(nxt, n) - idx, 1, LMAX)
    return b, ell, valid, raw


def run_rows(pk, inval, k: int, n: int):
    """Per-window run-row columns (meaningful at start positions):
    Wc content words + meta.  Content is UNMASKED here — beyond-span
    masking and dead-run sentinels are applied by pack_slots on the
    ~n/5 slotted rows instead of all n positions.  Dead (invalid) runs carry
    all-ones meta; live meta = (ell-1) << EBITS | 1 (< 2^30, so live
    rows can never alias the sentinel)."""
    Wc = content_words(k)
    b, ell, valid, raw = segment_runs(pk, inval, k, n)
    dead = jnp.uint32(0) - (1 - valid).astype(jnp.uint32)  # all-ones if invalid

    cols = [jax.lax.slice(raw, (16 * j,), (16 * j + n,)) for j in range(Wc)]
    meta = (((ell - 1).astype(jnp.uint32) << jnp.uint32(EBITS))
            | jnp.uint32(1)) | dead
    cols.append(meta)
    return b, tuple(_B(tuple(cols)))


# ---------------------------------------------------------------------------
# One-hot packing: route each tile's run rows into dense slots
# ---------------------------------------------------------------------------

def pack_slots(b, cols, n: int, S: int, k: int):
    """(per-window start flags, per-window row columns) -> (slotted
    columns [(n // TILE) * S], runs-per-tile max).

    Slot s of tile t receives the row of the (s+1)-th run START in the
    tile (exactly-one-nonzero one-hot matmul — exact in f32 since every
    output sums a single u16-ranged term).  Slots past the tile's run
    count and dead (invalid) runs become all-ones sentinel rows, and
    content words are masked to their ell + k - 1 span — all on the
    slotted rows (one fifth of the window mass).  Runs spanning tile
    boundaries belong to the tile containing their start; their content
    words were computed globally, so nothing is lost at the seam.
    """
    Bt = n // TILE
    ncols = len(cols)
    b2 = b.reshape(Bt, TILE)
    cum = jnp.cumsum(b2, axis=1)
    slot = cum - b2                      # exclusive: ordinal of each start
    runs = cum[:, -1]                    # runs per tile
    maxruns = jnp.max(runs)
    slot, runs = _B((slot, runs))

    # u32 -> two exact f32 halves per column
    v2 = []
    for c in cols:
        c2 = c.reshape(Bt, TILE)
        v2.append((c2 & jnp.uint32(0xFFFF)).astype(jnp.float32))
        v2.append((c2 >> jnp.uint32(16)).astype(jnp.float32))
    vals = jnp.stack(v2, axis=-1)        # (Bt, TILE, 2*ncols)

    s_iota = jax.lax.broadcasted_iota(jnp.int32, (1, 1, S), 2)

    def chunk(args):
        sl, bb, vv = args
        d = sl[:, :, None] - s_iota      # 0 where slot == s
        eq = (1 - jnp.minimum(jnp.abs(d), 1)) * bb[:, :, None]
        oh = eq.astype(jnp.float32)      # exactly-one-nonzero one-hot
        return jax.lax.dot_general(      # (g, S, 2*ncols)
            oh, vv,
            dimension_numbers=(((1,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
            # u16-ranged operands need full f32: the GPU's default f32
            # matmul may run in TF32 (10 mantissa bits), which would
            # silently mangle the recombined u32 rows
            precision=jax.lax.Precision.HIGHEST,
        )

    g = min(1024, Bt & -Bt)
    parts = jax.lax.map(chunk, (slot.reshape(-1, g, TILE),
                                b2.reshape(-1, g, TILE),
                                vals.reshape(-1, g, TILE, 2 * ncols)))
    packed = parts.reshape(Bt, S, 2 * ncols)
    packed = _B(packed)

    # recombine u32; sentinel-mask empty slots AND dead runs (meta bits
    # 30-31 nonzero iff the run was invalid — live meta < 2^30)
    sidx = jax.lax.broadcasted_iota(jnp.int32, (Bt, S), 1)
    deadslot = jax.lax.bitcast_convert_type(
        (runs[:, None] - 1 - sidx) >> 31, jnp.uint32)  # all-ones iff s >= runs
    meta_lo = packed[:, :, 2 * (ncols - 1)].astype(jnp.uint32)
    meta_hi = packed[:, :, 2 * ncols - 1].astype(jnp.uint32)
    meta = ((meta_hi << jnp.uint32(16)) | meta_lo) | deadslot
    deadrow = jnp.uint32(0) - jnp.minimum(
        meta >> jnp.uint32(30), jnp.uint32(1))          # all-ones iff dead
    ell = ((meta >> jnp.uint32(EBITS)) & jnp.uint32(15)).astype(jnp.int32) + 1
    span = ell + jnp.int32(k - 1)
    out = []
    for i in range(ncols - 1):
        lo = packed[:, :, 2 * i].astype(jnp.uint32)
        hi = packed[:, :, 2 * i + 1].astype(jnp.uint32)
        cw = (hi << jnp.uint32(16)) | lo
        # beyond-span mask: keep the top 2*nb bits of word i (shift
        # clamped to [0, 30]; nb = 0 columns are zeroed by the multiplier)
        nb = jnp.clip(span - 16 * i, 0, 16)
        sh = jnp.clip(32 - 2 * nb, 0, 30).astype(jnp.uint32)
        mask = (jnp.uint32(0xFFFFFFFF) << sh) \
            * jnp.minimum(nb, 1).astype(jnp.uint32)
        out.append(((cw & mask) | deadrow).reshape(-1))
    out.append((meta | deadrow).reshape(-1))
    return tuple(_B(tuple(out))), maxruns


# ---------------------------------------------------------------------------
# Fused superstep: packed stream + run-store prefix -> new run store
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("k", "n", "S", "dense"))
def skm_superstep(packed, sep, prefix, wstart=0, srow=0, *,
                  k: int, n: int, S: int, dense: bool = False):
    """One dispatch: segment -> pack run rows -> sort -> merge with the
    run-store prefix (embedded-count compaction, ebits=26).

    Same (packed, sep, wstart, srow) transfer contract and the same
    (prefix, nd) optimistic-verification contract as the counting
    supersteps in ops/sortcount.py, with a THIRD verification scalar:
    returns (new_prefix, [nd_exact, nd_used, max_tile_runs]).  The
    caller must replay with a larger S when max_tile_runs > S (slots
    past S were dropped), exactly like a capacity overflow.
    """
    Wc = content_words(k)
    packed, sep = sortcount._chunk_views(packed, sep, wstart, srow, k, n, dense)
    L = n + k - 1
    # packed words padded so mword reads stay in range (code bits of
    # invalid/past-end positions are zero by the pack contract)
    need_words = (n + 16 * (Wc - 1)) // 16 + 2
    pk = jnp.concatenate([
        packed,
        jnp.zeros((max(0, need_words - packed.shape[0]),), jnp.uint32)])
    with jax.named_scope("segpack"):
        inval = sortcount.invalid_from_dense(sep, L) if dense \
            else sortcount.invalid_from_sparse(sep, L)
        b, cols = run_rows(pk, inval, k, n)
        slotted, maxruns = pack_slots(b, cols, n, S, k)

    # merge slotted run rows into the store (sort + embedded-count
    # compaction at ebits=26)
    w = len(prefix) - 1
    cap = prefix[0].shape[0]
    merge_cols = [jnp.concatenate([prefix[i], slotted[i]])
                  for i in range(w - 1)]
    merge_cols.append(jnp.concatenate(
        [prefix[w - 1] | prefix[-1].astype(jnp.uint32), slotted[w - 1]]))
    store, nd = sortcount._compact_embedded(merge_cols, EBITS)
    return tuple(c[:cap] for c in store), \
        jnp.stack([nd, nd, maxruns]).astype(jnp.int32)


# ---------------------------------------------------------------------------
# Finalize: expand distinct runs into canonical window keys
# ---------------------------------------------------------------------------

def _expand_keys(cw, ell, k: int):
    """Distinct run rows -> canonical window keys for every slot.

    cw: list of Wc uint32 (R,) content columns; ell int32 (R,).
    Returns W = words_per_kmer(k) uint32 (R * LMAX,) columns (slot-major
    within each run: row r*LMAX + e is window e of run r), sentinel
    where e >= ell.  Keys are bit-identical to the streaming factory's
    (same big-endian packing, same canonical tie-break — reference:
    source/kmer_factory.cpp:219-233).
    """
    W = words_per_kmer(k)
    Wc = len(cw)
    R = cw[0].shape[0]
    r = k % 16
    topmask = jnp.uint32(0xFFFFFFFF) if r == 0 else \
        jnp.uint32(((1 << (2 * r)) - 1) << (32 - 2 * r))
    zero = jnp.zeros((R,), jnp.uint32)

    def word_at(o: int):
        """Big-endian 16-base word at span offset o (o may be negative
        or beyond Wc*16; out-of-span bases read as 0 and only ever land
        in masked bits)."""
        if o < 0:
            lead = cw[0] if Wc else zero
            return lead >> jnp.uint32(2 * (-o)) if -o < 16 else zero
        q, p = divmod(o, 16)
        a = cw[q] if q < Wc else zero
        if p == 0:
            return a
        bx = cw[q + 1] if q + 1 < Wc else zero
        return (a << jnp.uint32(2 * p)) | (bx >> jnp.uint32(32 - 2 * p))

    per_slot = []   # per_slot[e] = list of W canonical words
    for e in range(LMAX):
        fwd, rcw = [], []
        for wi in range(W):
            f = word_at(e + 16 * wi)
            g = _pairrev32(~word_at(e + k - 16 * (wi + 1)))
            if wi == W - 1:
                f, g = f & topmask, g & topmask
            fwd.append(f)
            rcw.append(g)
        carry = jnp.zeros((R,), jnp.int32)
        for f, g in zip(reversed(fwd), reversed(rcw)):
            carry = jnp.where(f < g, jnp.int32(-1),
                              jnp.where(f > g, jnp.int32(1), carry))
        per_slot.append([jnp.where(carry <= 0, f, g)
                         for f, g in zip(fwd, rcw)])

    # slot-validity sentinel: slot e dead iff e >= ell
    out = []
    for wi in range(W):
        col = jnp.stack([per_slot[e][wi] for e in range(LMAX)], axis=1)
        eidx = jax.lax.broadcasted_iota(jnp.int32, (R, LMAX), 1)
        smask = jax.lax.bitcast_convert_type(
            (eidx - ell[:, None]) >> 31, jnp.uint32) ^ SENTINEL
        out.append((col | smask).reshape(-1))
    return tuple(_B(tuple(out)))


@partial(jax.jit, static_argnames=("k", "hfn"))
def expand_chunk(run_cols, bloom=None, *, k: int, hfn: int = 0):
    """One finalize chunk: (Wc content cols, meta-key col, count col)
    -> (W key cols + int32 count col) over R * LMAX rows, unsorted.

    ``bloom``: optional BF2 word array — expanded k-mers whose root
    hash misses the filter are sentinel-masked here (the skm
    composition of the reference's pass-2 gate, parallel_parser.hpp:
    2436-2454: runs pack multiple windows so the per-window filter can
    only apply at expansion)."""
    *cw, metakey, cnt = run_cols
    ell = ((metakey >> jnp.uint32(EBITS)) & jnp.uint32(15)).astype(jnp.int32) + 1
    keys = _expand_keys(list(cw), ell, k)
    alive = jnp.minimum(cnt, 1)
    # dead run rows (cnt 0 / sentinel): ell garbage -> all slots sentinel
    dmask = jnp.uint32(0) - (1 - alive).astype(jnp.uint32)
    keys = tuple((x.reshape(ell.shape[0], LMAX) | dmask[:, None]).reshape(-1)
                 for x in keys)
    if bloom is not None:
        miss = sortcount._bloom_miss_mask(bloom, keys, hfn)
        keys = tuple(x | miss for x in keys)
    counts = jnp.broadcast_to(cnt[:, None],
                              (cnt.shape[0], LMAX)).reshape(-1)
    # zero counts on sentinel slots so compaction's alive test holds
    is_sent = sortcount._is_sentinel_i32(list(keys))
    counts = counts * (1 - is_sent)
    return keys + (counts,)


@partial(jax.jit, static_argnames=("k", "hfn"))
def _expand_compact(run_cols, bloom=None, *, k: int, hfn: int = 0):
    """Single-shot finalize: expand every run row and segment-reduce.
    The general compact: window counts sum MULTIPLE non-unit run
    counts, so the embedded single-non-unit trick does not apply at
    this stage.  The clamped segmented sum stays exact for unbounded
    rows per segment: one row per distinct run containing a k-mer
    means a low-complexity k-mer can exceed 2^32 true mass."""
    return sortcount.compact(expand_chunk(run_cols, bloom, k=k, hfn=hfn),
                             clamped=True)


@partial(jax.jit, static_argnames=("k", "chunk", "hfn"))
def _expand_merge_at(acc, run_cols, start, bloom=None, *, k: int,
                     chunk: int, hfn: int = 0):
    """Chunked finalize step: expand ``chunk`` run rows at a traced
    offset of the DEVICE-resident store and merge into acc (one compile
    per (cap, chunk) — the offset is dynamic)."""
    part = tuple(jax.lax.dynamic_slice(c, (start,), (chunk,))
                 for c in run_cols)
    rows = expand_chunk(part, bloom, k=k, hfn=hfn)
    cap = acc[0].shape[0]
    cols = tuple(jnp.concatenate([a, r]) for a, r in zip(acc, rows))
    store, nd = sortcount.compact(cols, clamped=True)
    return tuple(c[:cap] for c in store), nd


def finalize_store(run_store, k: int, chunk_rows: int = 1 << 20,
                   single_shot_rows: "int | None" = None,
                   bloom=None, hfn: int = 0):
    """DEVICE-side finalize: expand the distinct run store (device or
    NumPy columns: Wc content + meta-key + count) and segment-reduce
    into a sorted k-mer store ON DEVICE.  Returns (store columns —
    W uint32 key cols + int32 count col, n_used); rows past n_used and
    count-0 rows in between are sentinels/pads the caller must mask
    (same contract as the streaming prefix).  Nothing lands on host.

    Stores whose expansion fits ``single_shot_rows`` go through ONE
    expand + compact (no accumulator, no growth).  Larger stores loop
    device-side dynamic-slice chunks into a fixed-capacity accumulator,
    growing on overflow (the pre-merge acc stays live — compact does
    not donate — so an overflowing chunk simply re-merges bigger).
    """
    W = words_per_kmer(k)
    R = int(run_store[0].shape[0])
    if R == 0:
        return sortcount.make_store(0, W), 0
    if single_shot_rows is None:
        # bytes-aware: one expand+compact materializes ~3 sort
        # generations of (W+1) uint32 columns; budget ~6 GB of device
        # memory for it (an untuned default — ROADMAP S7)
        single_shot_rows = min(1 << 26, (6 << 30) // ((W + 1) * 12))
    # coerce dtypes: NumPy callers easily arrive with int64/int32 key
    # columns (np.stack of keys + an int32 count column promotes), and
    # signed key words silently break the sort order and sentinel masks
    run_cols = tuple(
        jnp.asarray(np.asarray(c).astype(
            np.int32 if i == len(run_store) - 1 else np.uint32))
        if not hasattr(c, "devices") else c
        for i, c in enumerate(run_store))
    if R * LMAX <= single_shot_rows:
        store, nd_h = _expand_compact(run_cols, bloom, k=k, hfn=hfn)
        return store, int(nd_h)

    # chunked path: pad the store to chunk granularity with sentinel
    # rows (count 0 -> dropped at expansion), then dynamic-slice chunks
    pad = (-R) % chunk_rows
    if pad:
        run_cols = tuple(
            jnp.concatenate([c, jnp.zeros((pad,), c.dtype)
                             if i == len(run_cols) - 1 else
                             jnp.full((pad,), SENTINEL, c.dtype)])
            for i, c in enumerate(run_cols))
    cap = sortcount.next_store_size(4 * chunk_rows, coarse=True)
    acc = sortcount.make_store(cap, W)
    nd = 0
    for s0 in range(0, R, chunk_rows):
        while True:
            new_acc, nd_h = _expand_merge_at(acc, run_cols, s0, bloom,
                                             k=k, chunk=chunk_rows, hfn=hfn)
            nd = int(nd_h)
            if nd <= acc[0].shape[0]:
                acc = new_acc
                break
            # double on the coarse ladder: every accumulator capacity
            # is a fresh compile, so growth must be geometric — but NOT
            # projected from nd_used (an overflowed chunk's nd_used is
            # input-mass bounded, and a linear projection of it
            # ballooned a 1 GB input's accumulator past device memory)
            cap = sortcount.next_store_size(
                max(nd, 2 * acc[0].shape[0]), coarse=True)
            acc = tuple(
                jnp.concatenate(
                    [c, sortcount.dead_fill((cap - c.shape[0],), c.dtype)])
                for c in acc)
    return acc, nd


def finalize_counts(run_store, k: int, chunk_rows: int = 1 << 20,
                    single_shot_rows: "int | None" = None):
    """Host-side finalize: ``finalize_store`` + one device->host fetch.
    Returns (keys (N, W) uint32 sorted, counts (N,) int64)."""
    store, nd = finalize_store(run_store, k, chunk_rows, single_shot_rows)
    if nd == 0:
        return (np.zeros((0, words_per_kmer(k)), np.uint32),
                np.zeros((0,), np.int64))
    keys = np.stack([np.asarray(c[:nd]) for c in store[:-1]], axis=1)
    cnt = np.asarray(store[-1][:nd]).astype(np.int64)
    live = cnt > 0
    return keys[live], cnt[live]


# ---------------------------------------------------------------------------
# NumPy mirror (oracle for unit tests)
# ---------------------------------------------------------------------------

def runs_np(codes, k: int, n: int):
    """Reference segmentation: list of (start, ell, valid) runs, same
    semantics as segment_runs (minimizer change / validity change /
    LMAX cap anchored at true boundaries, cap suppressed for invalid
    runs)."""
    codes = np.asarray(codes, np.uint8)
    L = n + k - 1
    base = (codes[:L] & 3).astype(np.uint32)
    inval = (codes[:L] >= 4)
    w = k - M + 1
    Wc = content_words(k)
    base_p = np.concatenate([base, np.zeros(n + 16 * (Wc - 1) + 15 - L,
                                            np.uint32)])
    raw = np.zeros(n + 16 * (Wc - 1), np.uint32)
    for j in range(16):
        raw = (raw << np.uint32(2)) | base_p[j: j + raw.shape[0]]
    minv = np.empty(n, np.uint32)
    valid = np.empty(n, bool)
    for t in range(n):
        valid[t] = not inval[t: t + k].any()
        if valid[t]:
            minv[t] = min(raw[t: t + w])
        else:
            minv[t] = 0xFFFFFFFF
    runs = []
    start = 0
    for t in range(1, n + 1):
        boundary = t == n or minv[t] != minv[t - 1] or valid[t] != valid[t - 1]
        if not boundary and valid[t] and (t - start) % LMAX == 0:
            boundary = True
        if boundary:
            runs.append((start, t - start, bool(valid[start])))
            start = t
    return runs, raw


def run_rows_np(codes, k: int, n: int) -> dict:
    """dict run-row tuple -> total count, mirroring the device rows."""
    runs, raw = runs_np(codes, k, n)
    Wc = content_words(k)
    out = {}
    for start, ell, valid in runs:
        if not valid:
            continue
        for s0 in range(0, ell, LMAX):   # np mirror of the cap
            ln = min(LMAX, ell - s0)
            span = ln + k - 1
            row = []
            for j in range(Wc):
                nb = min(max(span - 16 * j, 0), 16)
                mask = np.uint32(0) if nb == 0 else \
                    np.uint32(((1 << (2 * nb)) - 1) << (32 - 2 * nb))
                row.append(int(raw[start + s0 + 16 * j] & mask))
            row.append((ln - 1) << EBITS)
            key = tuple(row)
            out[key] = out.get(key, 0) + 1
    return out
