"""Multi-device sharded counting on the super-k-mer (minimizer-run)
pipeline — skm composed with the distributed path.

Streaming is identical in shape to ShardedSortCounter (pure data
parallelism: each device segments its own k-1-haloed span and merges
RUN rows into a device-local run store; zero collectives on the hot
path) — only the per-shard superstep differs (ops/skm.py:skm_superstep)
and each round additionally reports the per-tile run-slot high-water,
replicated with a pmax so every process takes the same S-ladder growth
decision (SPMD-uniform, like capacity growth).

Finalize is two phases:
  A. per-shard expansion: each shard expands its DISTINCT runs into
     canonical k-mer rows and segment-reduces them locally (chunked,
     device-resident, accumulator growth decided on a replicated pmax);
  B. the standard hash-prefix ``all_to_all`` exchange + per-shard
     compact, on the k-mer-format store (same exchange the classic
     sharded counter uses — runs merge exactly like keys, so only the
     column width differs).

Reference counterpart: none (the reference is single-node threads on
one shared table — SURVEY.md section 2.2); the exchange design is the
mapping note in SURVEY section 2.2 / BASELINE north star.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import skm, sortcount
from ..ops.hashing import hash_words
from ..utils import codec
from .sharded_sort import ShardedSortConfig, ShardedSortCounter


@dataclasses.dataclass
class ShardedSkmConfig(ShardedSortConfig):
    skm_slots: int = 96        # run-slot budget S per 512-window tile
                               # (ladder-doubled on overflow, max TILE)

    def __post_init__(self):
        super().__post_init__()
        if not skm.supported(self.k):
            raise ValueError(f"skm pipeline requires k >= {skm.M}")
        if self.batch_windows % skm.TILE:
            raise ValueError(
                f"batch_windows must be a multiple of {skm.TILE}")

    @property
    def words(self) -> int:
        """Store columns are RUN rows until finalize (see base note)."""
        return skm.store_words(self.k)


class ShardedSkmCounter(ShardedSortCounter):
    """ShardedSortCounter with the skm superstep + expand-then-exchange
    finalize.  Same user surface."""

    def __init__(self, config: ShardedSkmConfig, mesh: Mesh | None = None):
        self._S = int(config.skm_slots)
        super().__init__(config, mesh)
        self._kw = codec.words_per_kmer(config.k)
        self._expand_jits = {}
        self._kmer_exchange = None
        self.stats["slot_grow_events"] = 0

    # -- streaming superstep -------------------------------------------------

    def _build_superstep(self, cap: int, dense: bool):
        cfg = self.cfg
        k, n = cfg.k, cfg.batch_windows
        w = cfg.words
        S = self._S

        def body(packed, sep, prefix):
            pref = tuple(p[0] for p in prefix)
            new_prefix, ndv = skm.skm_superstep(
                packed[0], sep[0], pref, k=k, n=n, S=S, dense=dense)
            # ndv = [nd_exact, nd_used, max_tile_runs]; replicate the
            # growth-relevant maxima so every process branches alike
            return tuple(c[None, :] for c in new_prefix) + (
                ndv[None], jax.lax.pmax(ndv[1], "d"),
                jax.lax.pmax(ndv[2], "d"))

        return jax.jit(jax.shard_map(
            body, mesh=self.mesh,
            in_specs=(P("d", None), P("d", None),
                      tuple(P("d", None) for _ in range(w + 1))),
            out_specs=tuple(P("d", None) for _ in range(w + 1))
            + (P("d", None), P(), P()),
        ))

    def _dispatch_round(self, packed_d, sep_d, dense: bool):
        cap = self.prefix[0].shape[1]
        key = (cap, dense, self._S)
        if key not in self._superstep_jits:
            self._superstep_jits[key] = self._build_superstep(cap, dense)
        out = self._superstep_jits[key](packed_d, sep_d, self.prefix)
        # queue (nd_max, maxruns_max, replay)
        self._rounds.append(
            (out[-2], out[-1], (packed_d, sep_d, dense, self.prefix)))
        self.prefix = out[:-3]

    def _drain_rounds(self, keep: int = 0):
        while len(self._rounds) > keep:
            nd_max_h, maxruns_h, replay = self._rounds.popleft()
            maxruns = self._scalar(maxruns_h)
            if maxruns > self._S:
                # slot-budget overflow: some tile had more run starts
                # than S — the packer dropped rows.  Bump the ladder and
                # replay this round and everything chained after it.
                replays = [replay] + [r for (_, _, r) in self._rounds]
                self._rounds.clear()
                while self._S < maxruns:
                    self._S = min(self._S * 2, skm.TILE)
                self.stats["slot_grow_events"] += 1
                self.prefix = replay[-1]   # pre-overflow prefix, still live
                for packed_d, sep_d, dense, _old in replays:
                    self._dispatch_round(packed_d, sep_d, dense)
                    self._drain_rounds(keep=0)
                continue
            nd_max = self._scalar(nd_max_h)
            cap = replay[-1][0].shape[1]
            if nd_max <= cap:
                self.stats["compactions"] += 1
                continue
            replays = [replay] + [r for (_, _, r) in self._rounds]
            self._rounds.clear()
            new_cap = sortcount.next_store_size(
                min(cap + self.cfg.batch_windows, 2 * max(nd_max, cap)))
            if new_cap > self.cfg.prefix_cap:
                self.cfg.prefix_cap = new_cap
                self.stats["grow_events"] += 1
            self._retain(replays[0][-1], nd_max, force_cap=new_cap)
            for packed_d, sep_d, dense, _old in replays:
                self._dispatch_round(packed_d, sep_d, dense)
                self._drain_rounds(keep=0)

    # -- finalize: expand per shard, then exchange k-mer rows ----------------

    def _build_expand_step(self, run_cap: int, acc_cap: int, chunk: int):
        """One chunked expansion step, per shard: expand ``chunk`` run
        rows at a traced offset, merge into the shard's k-mer
        accumulator (clamped compact: rows-per-segment is unbounded at
        expansion), report the replicated max fill for SPMD-uniform
        accumulator growth."""
        k = self.cfg.k

        def body(run_cols, acc, start):
            rc = tuple(c[0] for c in run_cols)
            ac = tuple(a[0] for a in acc)
            part = tuple(jax.lax.dynamic_slice(c, (start[0],), (chunk,))
                         for c in rc)
            rows = skm.expand_chunk(part, k=k)
            cols = tuple(jnp.concatenate([a, r]) for a, r in zip(ac, rows))
            store, nd = sortcount.compact(cols, clamped=True)
            return tuple(c[:acc_cap][None] for c in store) + (
                jax.lax.pmax(nd, "d"),)

        return jax.jit(jax.shard_map(
            body, mesh=self.mesh,
            in_specs=(tuple(P("d", None) for _ in range(self.cfg.words + 1)),
                      tuple(P("d", None) for _ in range(self._kw + 1)),
                      P()),
            out_specs=tuple(P("d", None) for _ in range(self._kw + 1))
            + (P(),),
        ))

    def _build_kmer_exchange(self, cap: int):
        """The classic hash-prefix exchange, at k-mer column width."""
        w = self._kw

        def exchange_body(prefix):
            keys = [prefix[i][0] for i in range(w)]
            cnt = prefix[-1][0]
            p = cnt.shape[0]
            ndev = jax.lax.axis_size("d")
            shift = jnp.uint32(32 - (ndev - 1).bit_length()) if ndev > 1 \
                else None
            h = hash_words(tuple(keys))
            owner = (h >> shift).astype(jnp.int32) if ndev > 1 else \
                jnp.zeros((p,), jnp.int32)
            alive = jnp.minimum(cnt, 1)
            onehot = (owner[:, None]
                      == jnp.arange(ndev, dtype=jnp.int32)[None, :]
                      ).astype(jnp.int32) * alive[:, None]
            pos = jnp.cumsum(onehot, axis=0) - 1
            pos = jnp.take_along_axis(pos, owner[:, None], axis=1)[:, 0]
            idx = jnp.where(alive == 1, owner * p + pos, ndev * p)
            send_k = [jnp.full((ndev * p,), sortcount.SENTINEL)
                      for _ in range(w)]
            send_k = [s.at[idx].set(x, mode="drop")
                      for s, x in zip(send_k, keys)]
            send_c = jnp.zeros((ndev * p,), jnp.int32).at[idx].set(
                cnt, mode="drop")
            recv = []
            for arr in send_k + [send_c]:
                a = arr.reshape(ndev, p)
                a = jax.lax.all_to_all(a, "d", split_axis=0, concat_axis=0,
                                       tiled=False)
                recv.append(a.reshape(ndev * p))
            store, nd = sortcount.compact(tuple(recv[:w]) + (recv[w],))
            return tuple(c[None, :] for c in store) + (
                nd[None], jax.lax.pmax(nd, "d"))

        return jax.jit(jax.shard_map(
            exchange_body, mesh=self.mesh,
            in_specs=(tuple(P("d", None) for _ in range(w + 1)),),
            out_specs=tuple(P("d", None) for _ in range(w + 1))
            + (P("d"), P()),
        ))

    def finalize_exchange(self):
        self._merge()
        if self._exchanged:
            return
        kw = self._kw
        run_cap = self.prefix[0].shape[1]
        chunk = min(run_cap, 1 << 20)
        # pad the run store to chunk granularity (sentinel rows expand
        # to count-0 rows and drop at the compact)
        pad = (-run_cap) % chunk
        if pad:
            self._retain(self.prefix, run_cap, force_cap=run_cap + pad)
            run_cap += pad
        acc_cap = sortcount.next_store_size(min(4 * chunk * skm.LMAX,
                                                max(2 * chunk, 1 << 13)))
        acc = tuple(
            jnp.full((self.ndev, acc_cap), v, dt)
            if i <= kw - 1 else jnp.zeros((self.ndev, acc_cap), jnp.int32)
            for i, (v, dt) in enumerate(
                [(0xFFFFFFFF, jnp.uint32)] * kw + [(0, jnp.int32)]))
        acc = tuple(jax.device_put(a, self._sharding2) for a in acc)
        for s0 in range(0, run_cap, chunk):
            while True:
                key = (run_cap, acc[0].shape[1], chunk)
                if key not in self._expand_jits:
                    self._expand_jits[key] = self._build_expand_step(
                        run_cap, acc[0].shape[1], chunk)
                start = jax.device_put(np.full((1,), s0, np.int32))
                out = self._expand_jits[key](self.prefix, acc, start)
                nd_max = self._scalar(out[-1])
                if nd_max <= acc[0].shape[1]:
                    acc = out[:-1]
                    break
                # SPMD-uniform accumulator growth (replicated pmax);
                # nd_max is the exact required size — grow straight to
                # it so each chunk retries at most once;
                # coarse ladder: each capacity is a fresh compile
                new_cap = sortcount.next_store_size(nd_max, coarse=True)
                acc = tuple(
                    jnp.concatenate(
                        [a, jnp.broadcast_to(
                            sortcount.dead_fill((1, new_cap - a.shape[1]),
                                                a.dtype),
                            (self.ndev, new_cap - a.shape[1]))], axis=1)
                    for a in acc)
                acc = tuple(jax.device_put(a, self._sharding2) for a in acc)
        # phase B: the standard exchange at k-mer width
        key = acc[0].shape[1]
        if self._kmer_exchange is None or self._kmer_exchange[0] != key:
            self._kmer_exchange = (key, self._build_kmer_exchange(key))
        out = self._kmer_exchange[1](acc)
        store, nd_max = out[:-2], out[-1]
        self.prefix = store          # NOW k-mer format (kw + 1 cols)
        self._retain_kmer(store, self._scalar(nd_max))
        self._exchanged = True

    def _retain_kmer(self, store, nd_max: int):
        """Post-exchange retain at k-mer width (shard-local resize)."""
        cap = sortcount.next_store_size(max(nd_max, 1))
        total = store[-1].shape[1]
        if cap >= total:
            self.prefix = store
            return
        w = self._kw

        def resize_body(cols):
            return tuple(c[0][:cap][None] for c in cols)

        fn = jax.jit(jax.shard_map(
            resize_body, mesh=self.mesh,
            in_specs=(tuple(P("d", None) for _ in range(w + 1)),),
            out_specs=tuple(P("d", None) for _ in range(w + 1)),
        ))
        self.prefix = fn(tuple(store))

    # -- output (k-mer width after finalize) ----------------------------------

    def dump(self):
        self.finalize_exchange()
        w = self._kw
        cols = [np.asarray(jax.device_get(c)).reshape(-1)
                for c in self.prefix]
        cnt = cols[-1].astype(np.int64)
        alive = cnt > 0
        keys = np.stack([c[alive] for c in cols[:w]], axis=1)
        cnt = cnt[alive]
        order = np.lexsort(tuple(keys[:, i] for i in range(w - 1, -1, -1)))
        return keys[order], cnt[order]

    def find(self, kmers) -> list:
        if isinstance(kmers, str):
            kmers = [kmers]
        tk, cn = self.dump()
        packed = np.zeros((len(kmers), self._kw), np.uint32)
        ok = np.ones(len(kmers), bool)
        for i, s in enumerate(kmers):
            if len(s) != self.cfg.k or any(ch not in "ACGTacgt" for ch in s):
                ok[i] = False
                continue
            packed[i] = codec.pack_kmer(codec.canonical(s.upper()))
        out = self._clip(sortcount.lookup_sorted(tk, cn, packed))
        return [int(c) if good else -1 for c, good in zip(out, ok)]
