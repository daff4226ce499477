"""Streaming counter on the super-k-mer (minimizer-run) pipeline.

Same user surface and the same streaming / optimistic-dispatch /
grow-and-replay machinery as models.sort_counter.SortKmerCounter — only
the device superstep differs: instead of sorting one row per window
(ops/sortcount.py), the stream is segmented into minimizer runs and the
~n/12 deduplicating RUN rows are sorted and merged into a run store
(ops/skm.py).  Canonical k-mer keys materialize once, at finalize, from
the distinct runs (~genome mass, not stream mass).

Extra verification scalar: each superstep reports the maximum number of
run starts in any 512-window tile; when it exceeds the slot budget S
the superstep dropped rows, so the driver bumps S one ladder step and
replays — the run-domain analogue of capacity grow-and-replay (the
reference's analogous failure is table-full exit(1),
source/kmer_hash_table.cpp:2553-2556, replaced here like everywhere
else by replay).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ops import skm
from ..utils import codec
from .sort_counter import SortCounterConfig, SortKmerCounter


@dataclasses.dataclass
class SkmCounterConfig(SortCounterConfig):
    skm_slots: int = 96        # run-slot budget S per 512-window tile
                               # (ladder-doubled on overflow, max TILE)

    def __post_init__(self):
        super().__post_init__()
        if not skm.supported(self.k):
            raise ValueError(f"skm pipeline requires k >= {skm.M}")
        if self.batch_windows % skm.TILE:
            raise ValueError(
                f"batch_windows must be a multiple of {skm.TILE}")
        if max(self.rows, skm.TILE) % skm.TILE:
            # tail_windows() aligns tails to max(rows, TILE); pack_slots'
            # reshape(n // TILE, TILE) needs that to stay TILE-aligned.
            # (Unreachable while the base class forces power-of-two rows
            # — kept as the explicit invariant.)
            raise ValueError(f"rows > {skm.TILE} must be a multiple "
                             f"of {skm.TILE}")

    @property
    def words(self) -> int:
        """Store columns are RUN rows (content words + meta), not k-mer
        words — every store-shaped base mechanism (make_store, sizing,
        checkpointing) works unchanged on this width."""
        return skm.store_words(self.k)

    def tail_windows(self, r: int) -> int:
        """Tail supersteps must stay TILE-aligned for the slot packer."""
        step = max(self.rows, skm.TILE)
        return min(-(-max(r, 1) // step) * step, self.superstep_windows)


class SkmCounter(SortKmerCounter):
    """Super-k-mer streaming counter (drop-in for SortKmerCounter)."""

    def __init__(self, config: SkmCounterConfig):
        super().__init__(config)
        self._S = config.skm_slots
        self._final_cache = None
        self._eff_min = 0          # prefix size an overflow proved necessary
        self._deltas = []          # last verified distinct-growth deltas
        self.stats["slot_grow_events"] = 0

    # -- device steps --------------------------------------------------------

    def _eff_for_dispatch(self, n: int) -> int:
        """Run-store prefix working size for the next merge.

        Overrides the base policy, which sizes from the ALL-TIME
        maximum verified distinct growth: the first superstep of any
        job sees mostly-novel content, so its delta (the whole genome's
        run count) poisons the maximum and pins the prefix at full
        capacity for the rest of the stream — at the bench that is
        8.4M sorted prefix rows per merge covering 2.8M live ones.
        Run growth at steady coverage is set by the RECENT novelty
        rate, so size from the last few verified deltas on the fine
        ladder; an underguess is caught by the existing overflow
        verification and replayed bigger, exactly like every other
        optimistic size here — never below the size that overflow
        established, or the replay would slice the grown store back
        down and overflow again."""
        from ..ops import sortcount
        cap = self.cfg.prefix_cap
        if cap <= (1 << 12):
            return cap
        if self._deltas:
            recent = max(self._deltas[-3:])
            target = self.n_used + \
                (self._max_inflight + 1) * max(recent, n // 256)
        else:
            # cold start: expected distinct runs of one superstep
            # (~n/14 run rows on 150 bp reads at 30x coverage; a
            # novel-heavy stream overflows once and replays at the
            # grown size)
            target = max(n // 32, 1 << 14)
        eff = min(max(sortcount.next_store_size(target), self._eff_min), cap)
        if self._inflight:
            # unverified in-flight outputs may hold up to the current
            # allocated length of live rows — never slice below it
            eff = max(eff, self.prefix[0].shape[0])
        return eff

    def _dispatch(self, packed_d, sep_d, n: int, dense: bool,
                  wstart: int = 0, srow: int = 0):
        prefix_in = self._sized_prefix(self._eff_for_dispatch(n))
        new_prefix, ndv = skm.skm_superstep(
            packed_d, sep_d, prefix_in, wstart, srow,
            k=self.cfg.k, n=n, S=self._S, dense=dense)
        self._inflight.append(
            (new_prefix, ndv,
             (packed_d, sep_d, n, dense, wstart, srow, prefix_in)))
        self.prefix = new_prefix
        self._final_cache = None

    def _replay_all(self, replays):
        for replay in replays:
            packed_d, sep_d, n, dense, wstart, srow = replay[:6]
            self._dispatch(packed_d, sep_d, n, dense, wstart, srow)
            self._drain(keep=0)

    def _drain(self, keep: int = 0):
        """Base drain plus the run-slot overflow check.

        Each superstep reports max_tile_runs (3rd scalar): > S means the
        packer dropped rows -> bump the S ladder and replay everything
        optimistically chained after the failed superstep (inputs stay
        live in the deque)."""
        while len(self._inflight) > keep:
            new_prefix, nd_h, replay = self._inflight.popleft()
            nd_exact, nd, maxruns = (int(x) for x in np.asarray(nd_h))
            cap_used = replay[-1][0].shape[0]
            if maxruns > self._S:
                replays = [replay] + [r for (_, _, r) in self._inflight]
                self._inflight.clear()
                while self._S < maxruns:
                    self._S = min(self._S * 2, skm.TILE)
                self.stats["slot_grow_events"] += 1
                self.prefix = replay[-1]   # pre-overflow prefix, still live
                self._replay_all(replays)
                continue
            if nd <= cap_used:
                delta = nd_exact - self.n_distinct
                self._deltas.append(max(delta, 0))
                del self._deltas[:-8]
                self.n_distinct = nd_exact
                self.n_used = nd
                self.stats["compactions"] += 1
                continue
            # run-store capacity overflow: identical to the base path
            import jax.numpy as jnp

            from ..ops import sortcount

            replays = [replay] + [r for (_, _, r) in self._inflight]
            self._inflight.clear()
            n_over = replay[2]
            bound = min(cap_used + n_over, 2 * max(nd, cap_used))
            new_eff = self._step_up(bound)
            self._eff_min = max(self._eff_min, new_eff)
            if new_eff > self.cfg.prefix_cap:
                self.cfg.prefix_cap = new_eff
                self.stats["grow_events"] += 1
            old_prefix = replay[-1]
            pad = new_eff - old_prefix[0].shape[0]
            self.prefix = tuple(
                jnp.concatenate([col, sortcount.dead_fill((pad,), col.dtype)])
                for col in old_prefix
            )
            self._replay_all(replays)

    # -- output --------------------------------------------------------------

    def finalize_device(self):
        """Finalize ON DEVICE: expand the distinct run store into the
        standard sorted k-mer store (W key cols + count col, device
        arrays) + n_used, cached until more input arrives.  Streaming
        may continue afterwards — expansion reads the run store without
        mutating it.  This is the skm analogue of the classic
        pipeline's end-of-stream state (no device->host transfer)."""
        self._flush()
        self._merge()
        tag = (self.stats["windows_processed"], self.n_used)
        if self._final_cache is not None and self._final_cache[0] == tag:
            return self._final_cache[1]
        # device-resident: slice the live region to a ladder size
        # (bounded compile variants; rows past n_used are sentinels with
        # count 0 and drop at expansion) — no host round-trip.  The
        # finalize ladder is FINER than the store ladder ({1, 1.125,
        # 1.25, 1.5, 1.75} x 2^m): expansion multiplies slack by LMAX
        # rows, and finalize runs once per job so the extra compile
        # variants amortize (the coarse ladder can pad a 2.2M-run store
        # to 3.1M -> 14M dead expanded rows)
        m = self.prefix[0].shape[0]
        need = max(self.n_used, 1)
        if need < m:
            lo = 1 << max((need - 1).bit_length() - 3, 3)
            m = min(m, -(-need // lo) * lo)
        run_cols = tuple(c[:m] for c in self.prefix)
        out = skm.finalize_store(run_cols, self.cfg.k)
        self._final_cache = (tag, out)
        return out

    def distinct_kmers(self) -> int:
        """Exact finalized distinct k-mer count (ONE scalar fetch — the
        run-store n_distinct counts RUNS, not k-mers; artifacts must
        report this number)."""
        store, nd = self.finalize_device()
        if nd == 0:
            return 0
        import jax.numpy as jnp
        return int(jnp.sum(jnp.minimum(store[-1][:nd], 1)))

    def dump(self):
        """(keys (N, W) uint32 sorted, counts (N,) int64): the device
        finalize + one host fetch (consumers that only need device
        state should use finalize_device)."""
        store, nd = self.finalize_device()
        if nd == 0:
            return (np.zeros((0, codec.words_per_kmer(self.cfg.k)),
                             np.uint32), np.zeros((0,), np.int64))
        keys = np.stack([np.asarray(c[:nd]) for c in store[:-1]], axis=1)
        cnt = np.asarray(store[-1][:nd]).astype(np.int64)
        live = cnt > 0
        return keys[live], cnt[live]

    # -- checkpoint / resume --------------------------------------------------

    @classmethod
    def load(cls, path: str, config: "SkmCounterConfig | None" = None):
        z = np.load(path)
        if config is None:
            config = SkmCounterConfig(
                k=int(z["k"]), mode=int(z["mode"]),
                min_abundance=int(z["min_abundance"]))
        return super().load(path, config)
