"""Multi-device sharded counting on the sort backend (the flagship path).

Communication-minimal design (contrast with the reference, whose only
parallelism is threads CAS-ing one shared table — SURVEY.md section 2.2,
include/parallel_parser.hpp):

- **streaming is pure data parallelism**: every device extracts window
  keys from its own contiguous span of the input stream (host splits
  each superbatch into per-device spans with a k-1 halo) and merges them
  into a device-local distinct (key, count) prefix.  Zero collectives on
  the hot path.
- **finalize exchanges only distinct records**: each device routes its
  compacted records to an owner shard keyed on the top bits of a key
  hash (uniform even for skewed genomes) via one ``all_to_all`` over the
  mesh axis, then compacts its received partition.  Communication volume
  is proportional to the number of distinct k-mers, not to the stream.

After ``finalize_exchange`` the global table is partitioned by hash
prefix: shard d holds the sorted distinct records whose owner bits are
d.  The host-side dump concatenates shards and sorts rows for the
output contract.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..io import codebuf
from ..io import fastio
from ..ops import sortcount
from ..ops.hashing import hash_words
from ..utils import codec
from .sharded import make_mesh


@dataclasses.dataclass
class ShardedSortConfig:
    k: int
    mode: int = 2
    min_abundance: int = 2
    batch_windows: int = 1 << 22   # windows per device per round (power of two)
    rows: int = 1 << 11
    merge_every: int = 4           # retained for config compat; the fused
                                   # superstep merges once per round
    prefix_cap: int = 1 << 20      # per-device distinct capacity; grows on demand
    winkeys: str = "codes"         # window-key extraction, as in
                                   # SortCounterConfig (codes/packed)

    def __post_init__(self):
        sortcount.check_winkeys(self.winkeys)
        if self.k < 2:
            raise ValueError("k must be >= 2")
        if self.batch_windows & (self.batch_windows - 1):
            raise ValueError("batch_windows must be a power of two")
        if self.rows & (self.rows - 1) or self.rows > self.batch_windows:
            raise ValueError("rows must be a power of two <= batch_windows")

    @property
    def words(self) -> int:
        return codec.words_per_kmer(self.k)


class ShardedSortCounter:
    """Same surface as models.sort_counter.SortKmerCounter, over a mesh."""

    def __init__(self, config: ShardedSortConfig, mesh: Mesh | None = None):
        self.cfg = config
        self.mesh = mesh if mesh is not None else make_mesh()
        self.ndev = int(self.mesh.devices.size)
        w = config.words
        cap = config.prefix_cap
        self._sharding2 = NamedSharding(self.mesh, P("d", None))
        self.prefix = tuple(
            self._put_const(0xFFFFFFFF, np.uint32, cap) for _ in range(w)
        ) + (self._put_const(0, np.int32, cap),)
        self._buf = codebuf.CodeBuffer()
        self._exchanged = False
        self.stats = {"windows_processed": 0, "batches": 0, "compactions": 0,
                      "grow_events": 0}
        # fused supersteps (unpack -> windows -> merge-with-prefix in ONE
        # dispatch per round, exactly like the single-device flagship);
        # jitted lazily per (cap, dense) shape
        self._superstep_jits = {}
        # optimistic chaining: round r+1 dispatches on round r's
        # unverified output prefix; the growth check (a replicated pmax
        # scalar read — a full device sync) trails by _max_inflight
        # rounds, exactly like the single-device pipeline
        import collections

        self._rounds = collections.deque()
        self._max_inflight = 2

        def exchange_body(prefix):
            # route alive records to owner = top hash bits; sentinel-fill
            keys = [prefix[i][0] for i in range(w)]
            cnt = prefix[-1][0]
            p = cnt.shape[0]
            ndev = jax.lax.axis_size("d")
            shift = jnp.uint32(32 - (ndev - 1).bit_length()) if ndev > 1 else None
            h = hash_words(tuple(keys))
            owner = (h >> shift).astype(jnp.int32) if ndev > 1 else jnp.zeros(
                (p,), jnp.int32)
            alive = jnp.minimum(cnt, 1)  # {0,1} int32

            # position within owner bucket (one-hot cumsum; finalize-only)
            onehot = (owner[:, None] == jnp.arange(ndev, dtype=jnp.int32)[None, :]
                      ).astype(jnp.int32) * alive[:, None]
            pos = jnp.cumsum(onehot, axis=0) - 1
            pos = jnp.take_along_axis(pos, owner[:, None], axis=1)[:, 0]

            idx = jnp.where(alive == 1, owner * p + pos, ndev * p)
            send_k = [jnp.full((ndev * p,), sortcount.SENTINEL) for _ in range(w)]
            send_k = [s.at[idx].set(x, mode="drop") for s, x in zip(send_k, keys)]
            send_c = jnp.zeros((ndev * p,), jnp.int32).at[idx].set(cnt, mode="drop")

            recv = []
            for arr in send_k + [send_c]:
                a = arr.reshape(ndev, p)
                a = jax.lax.all_to_all(a, "d", split_axis=0, concat_axis=0,
                                       tiled=False)
                recv.append(a.reshape(ndev * p))
            store, nd = sortcount.compact(tuple(recv[:w]) + (recv[w],))
            return tuple(c[None, :] for c in store) + (nd[None],
                                                       jax.lax.pmax(nd, "d"))

        self._exchange = jax.jit(jax.shard_map(
            exchange_body, mesh=self.mesh,
            in_specs=(tuple(P("d", None) for _ in range(w + 1)),),
            out_specs=tuple(P("d", None) for _ in range(w + 1)) + (P("d"), P()),
        ))
        self._resize_jits = {}

    # -- placement (overridden by the multi-host subclass) -------------------

    def _put_const(self, fill, dtype, cap: int):
        """Global (ndev, cap) constant store column."""
        return jax.device_put(
            jnp.full((self.ndev, cap), fill, dtype), self._sharding2)

    def _put_rows(self, rows_np: np.ndarray):
        """Global (ndev, n) array from per-device host rows (this
        process's rows only under multi-process)."""
        return jax.device_put(jnp.asarray(rows_np), self._sharding2)

    @staticmethod
    def _scalar(x) -> int:
        """Read a replicated/global scalar in a multi-process-safe way."""
        try:
            return int(np.asarray(x))
        except Exception:
            return int(np.asarray(
                jax.device_get(x.addressable_shards[0].data)))

    # -- streaming ---------------------------------------------------------

    def add_codes(self, codes: np.ndarray):
        self._buf.append(codes)
        sb = self.ndev * self.cfg.batch_windows
        need = sb + self.cfg.k - 1
        while len(self._buf) >= need:
            # zero-copy view in the common (large-chunk) case; the k-1
            # overlap is cursor arithmetic, not a carry copy (see
            # io/codebuf.py — the old per-superbatch re-concatenation
            # measured ~half the bench wall time)
            self._flush(self._buf.take(need, sb), sb)

    def finish(self):
        stream = self._buf.take_all()
        if stream.shape[0] >= self.cfg.k:
            sb = self.ndev * self.cfg.batch_windows
            padded = np.full(sb + self.cfg.k - 1, codec.SEP, np.uint8)
            m = min(stream.shape[0], padded.shape[0])
            padded[:m] = stream[:m]
            self._flush(padded, stream.shape[0] - self.cfg.k + 1)
        self._merge()

    def count_codes(self, codes: np.ndarray):
        self.add_codes(np.asarray(codes, np.uint8))
        self.finish()
        return self

    def count_file(self, path: str, **kw):
        from ..io import reader as io_reader

        for codes in io_reader.CodeChunkReader(path, **kw):
            self.add_codes(codes)
        self.finish()
        return self

    def _pack_rows(self, stream: np.ndarray, nrows: int,
                   force_dense: bool = False):
        """Split one round's stream into per-device spans (k-1 halo),
        2-bit pack each, and build the separator representation: a
        sparse index matrix (one of two static budgets) or the dense
        bitmap when separators are dense — or when ``force_dense``
        (multi-host lockstep needs every process to pick the same
        program without communicating the separator census)."""
        cfg = self.cfg
        k, n = cfg.k, cfg.batch_windows
        need = n + k - 1
        nwords = (need + 15) // 16
        mwords = (need + 31) // 32
        packed = np.zeros((nrows, nwords), np.uint32)
        masks = np.zeros((nrows, mwords), np.uint32)
        seps = []
        for d in range(nrows):
            span = stream[d * n: (d + 1) * n + k - 1]
            p, m = fastio.pack_stream(span)
            packed[d, : p.shape[0]] = p
            masks[d, : m.shape[0]] = m
            if not force_dense:
                seps.append(np.flatnonzero(span >= 4).astype(np.uint32))
        if force_dense:
            return packed, masks, True
        small, big = max(need // 128, 32), max(need // 32, 32)
        worst = max((s.shape[0] for s in seps), default=0)
        if worst > big:
            return packed, masks, True
        budget = small if worst <= small else big
        sep_h = np.full((nrows, budget), need, np.uint32)
        for d, s in enumerate(seps):
            sep_h[d, : s.shape[0]] = s
        return packed, sep_h, False

    def _build_superstep(self, cap: int, dense: bool):
        cfg = self.cfg
        k, n, rows = cfg.k, cfg.batch_windows, min(cfg.rows, cfg.batch_windows)
        w = cfg.words
        eb = sortcount.embed_bits(k)
        wk = cfg.winkeys

        def body(packed, sep, prefix):
            pref = tuple(p[0] for p in prefix)
            if eb >= 21:
                new_prefix, nd = sortcount.superstep_embedded(
                    packed[0], sep[0], pref, k=k, n=n, rows=rows,
                    ebits=eb, dense=dense, winkeys=wk)
            else:
                new_prefix, nd = sortcount.superstep_plain(
                    packed[0], sep[0], pref, k=k, n=n, rows=rows,
                    dense=dense, winkeys=wk)
            # replicated global max so every process agrees on growth
            # decisions without gathering non-addressable shards
            return tuple(c[None, :] for c in new_prefix) + (
                nd[None], jax.lax.pmax(nd[1], "d"))

        return jax.jit(jax.shard_map(
            body, mesh=self.mesh,
            in_specs=(P("d", None), P("d", None),
                      tuple(P("d", None) for _ in range(w + 1))),
            out_specs=tuple(P("d", None) for _ in range(w + 1))
            + (P("d", None), P()),
        ))

    def _run_superstep(self, packed_d, sep_d, dense: bool):
        """Dispatch one fused round optimistically; verify the round
        that is now _max_inflight behind (growth decisions read a
        REPLICATED pmax scalar, so every process takes the same
        branch)."""
        self._drain_rounds(keep=self._max_inflight - 1)
        self._dispatch_round(packed_d, sep_d, dense)

    def _dispatch_round(self, packed_d, sep_d, dense: bool):
        cap = self.prefix[0].shape[1]
        key = (cap, dense)
        if key not in self._superstep_jits:
            self._superstep_jits[key] = self._build_superstep(cap, dense)
        out = self._superstep_jits[key](packed_d, sep_d, self.prefix)
        self._rounds.append(
            (out[-1], (packed_d, sep_d, dense, self.prefix)))
        self.prefix = out[:-2]

    def _drain_rounds(self, keep: int = 0):
        """Verify queued rounds down to ``keep``; on per-shard overflow,
        grow every shard's capacity one ladder step past the replicated
        max, re-pad the pre-overflow prefix, and replay this round plus
        every optimistically-chained one (inputs stay device-resident
        in the queue until verified)."""
        while len(self._rounds) > keep:
            nd_max_h, replay = self._rounds.popleft()
            nd_max = self._scalar(nd_max_h)
            cap = replay[-1][0].shape[1]   # input prefix cap = output cap
            if nd_max <= cap:
                self.stats["compactions"] += 1
                continue
            replays = [replay] + [r for (_, r) in self._rounds]
            self._rounds.clear()
            new_cap = sortcount.next_store_size(
                min(cap + self.cfg.batch_windows, 2 * max(nd_max, cap)))
            if new_cap > self.cfg.prefix_cap:
                self.cfg.prefix_cap = new_cap
                self.stats["grow_events"] += 1
            self._retain(replays[0][-1], nd_max, force_cap=new_cap)
            for packed_d, sep_d, dense, _old in replays:
                self._dispatch_round(packed_d, sep_d, dense)
                self._drain_rounds(keep=0)   # verify replays synchronously

    def _flush(self, stream: np.ndarray, n_real: int):
        if self._exchanged:
            raise RuntimeError("cannot add input after finalize")
        packed, sep, dense = self._pack_rows(stream, self.ndev)
        self._run_superstep(self._put_rows(packed), self._put_rows(sep), dense)
        self.stats["batches"] += 1
        self.stats["windows_processed"] += max(n_real, 0)

    # -- merging -----------------------------------------------------------

    def _merge(self):
        """The fused superstep merges every round — this is just the
        pipeline sync point (verify all in-flight rounds)."""
        self._drain_rounds(keep=0)

    def _retain(self, store, nd_max: int, force_cap: "int | None" = None):
        """Keep a prefix_cap-sized slice of the merged store (growing the
        cap first if any shard's distinct count would not fit).  The
        resize is a shard-local jitted program (no collectives) so it is
        multi-process-safe."""
        if force_cap is None:
            while nd_max > self.cfg.prefix_cap:
                self.cfg.prefix_cap *= 2
                self.stats["grow_events"] += 1
            cap = self.cfg.prefix_cap
        else:
            cap = force_cap
        total = store[-1].shape[1]
        if cap == total:
            self.prefix = store
            return
        w = self.cfg.words
        key = (total, cap)
        if key not in self._resize_jits:
            def resize_body(cols):
                out = []
                for c2 in cols:
                    c = c2[0]
                    if cap <= c.shape[0]:
                        out.append(c[:cap][None])
                    else:
                        out.append(jnp.concatenate(
                            [c, sortcount.dead_fill((cap - c.shape[0],),
                                                    c.dtype)])[None])
                return tuple(out)

            self._resize_jits[key] = jax.jit(jax.shard_map(
                resize_body, mesh=self.mesh,
                in_specs=(tuple(P("d", None) for _ in range(w + 1)),),
                out_specs=tuple(P("d", None) for _ in range(w + 1)),
            ))
        self.prefix = self._resize_jits[key](tuple(store))

    def finalize_exchange(self):
        """Route distinct records to hash-prefix owner shards (one
        all_to_all) and compact each shard's partition."""
        self._merge()
        if self._exchanged:
            return
        out = self._exchange(self.prefix)
        store, nd_max = out[:-2], out[-1]
        self._retain(store, self._scalar(nd_max))
        self._exchanged = True

    # -- output ------------------------------------------------------------

    def _clip(self, counts: np.ndarray) -> np.ndarray:
        if self.cfg.mode == 0:
            return counts & 0xFFFF
        return np.minimum(counts, 16383)

    def dump(self):
        """(keys (N, W) uint32 lexicographically sorted, counts (N,)) of
        all distinct k-mers across shards."""
        self.finalize_exchange()
        w = self.cfg.words
        cols = [np.asarray(jax.device_get(c)).reshape(-1) for c in self.prefix]
        cnt = cols[-1].astype(np.int64)
        alive = cnt > 0
        keys = np.stack([c[alive] for c in cols[:w]], axis=1)
        cnt = cnt[alive]
        order = np.lexsort(tuple(keys[:, i] for i in range(w - 1, -1, -1)))
        return keys[order], cnt[order]

    def as_dict(self) -> dict:
        tk, cn = self.dump()
        cn = self._clip(cn)
        keep = cn >= self.cfg.min_abundance
        names = codec.unpack_kmers(tk[keep], self.cfg.k) if keep.any() else []
        return dict(zip(names, cn[keep].tolist()))

    def write_output(self, path: str) -> int:
        tk, cn = self.dump()
        cn = self._clip(cn)
        keep = cn >= self.cfg.min_abundance
        tk, cn = tk[keep], cn[keep]
        n = tk.shape[0]
        with open(path, "wb") as f:
            if n:
                k = self.cfg.k
                chars = np.empty((n, k), np.uint8)
                for i in range(k):
                    chars[:, i] = (tk[:, i // 16] >> np.uint32(30 - 2 * (i % 16))) & np.uint32(3)
                lut = np.frombuffer(b"ACGT", np.uint8)
                kmer_b = lut[chars].view(f"S{k}").ravel().astype(object)
                cnt_b = cn.astype(f"S{len(str(int(cn.max())))}").astype(object)
                f.write(b"".join((kmer_b + b" " + cnt_b + b"\n").tolist()))
        return int(n)

    def find(self, kmers) -> list:
        if isinstance(kmers, str):
            kmers = [kmers]
        tk, cn = self.dump()
        w = self.cfg.words
        packed = np.zeros((len(kmers), w), np.uint32)
        ok = np.ones(len(kmers), bool)
        for i, s in enumerate(kmers):
            if len(s) != self.cfg.k or any(ch not in "ACGTacgt" for ch in s):
                ok[i] = False
                continue
            packed[i] = codec.pack_kmer(codec.canonical(s.upper()))
        out = self._clip(sortcount.lookup_sorted(tk, cn, packed))
        return [int(c) if good else -1 for c, good in zip(out, ok)]

    def occupancy(self):
        self._merge()
        cnt = np.asarray(jax.device_get(self.prefix[-1]))
        return int((cnt > 0).sum()), int(cnt.size)

    # -- checkpoint / resume -------------------------------------------------
    # (the reference is single-shot with no persistence — SURVEY.md
    # section 5; snapshots let long sharded jobs survive preemption)

    def save(self, path: str):
        """Snapshot the per-shard distinct records WITHOUT the finalize
        exchange, plus the not-yet-processed tail bytes (carry +
        pending), so windows spanning the checkpoint boundary are
        neither lost nor double-counted on resume.  The same key may
        appear on several shards with partial counts — they are summed
        by the first compaction after restore, so counting can resume
        on any mesh size.  The live counter is left untouched."""
        if self._exchanged:
            raise RuntimeError("cannot checkpoint after finalize")
        self._merge()
        w = self.cfg.words
        cols = [np.asarray(jax.device_get(c)).reshape(-1) for c in self.prefix]
        cnt = cols[-1]
        alive = cnt > 0
        keys = np.stack([c[alive] for c in cols[:w]], axis=1)
        tail = self._buf.take_all()
        self._buf.append(tail)   # the live counter is left untouched
        np.savez_compressed(
            path, kind="sharded_sort", k=self.cfg.k, mode=self.cfg.mode,
            min_abundance=self.cfg.min_abundance, keys=keys,
            counts=cnt[alive].astype(np.int64), tail=tail,
            windows_processed=self.stats["windows_processed"],
        )

    @classmethod
    def load(cls, path: str, config: "ShardedSortConfig | None" = None,
             mesh: Mesh | None = None):
        """Restore from ``save`` output onto a (possibly different-size)
        mesh; counting can resume."""
        z = np.load(path)
        k = int(z["k"])
        if config is None:
            config = ShardedSortConfig(
                k=k, mode=int(z["mode"]),
                min_abundance=int(z["min_abundance"]))
        elif config.k != k:
            raise ValueError(f"checkpoint is for k={k}, config has k={config.k}")
        self = cls(config, mesh)
        keys = z["keys"].astype(np.uint32)
        cnt = z["counts"].astype(np.int64)
        # The checkpoint concatenates per-shard partitions: the same key
        # may appear several times with PARTIAL counts, and the rows are
        # not globally sorted.  The fused supersteps require each
        # shard's prefix to be a SORTED run with at most one record per
        # key (the c_last segment trick breaks otherwise), so aggregate
        # + sort host-side before re-partitioning.
        if keys.shape[0]:
            w0 = keys.shape[1]
            order = np.lexsort(tuple(keys[:, i] for i in range(w0 - 1, -1, -1)))
            keys, cnt = keys[order], cnt[order]
            first = np.ones(keys.shape[0], bool)
            first[1:] = (keys[1:] != keys[:-1]).any(axis=1)
            starts = np.flatnonzero(first)
            cnt = np.add.reduceat(cnt, starts)
            keys = keys[starts]
        n = keys.shape[0]
        per = -(-max(n, 1) // self.ndev)
        while per > self.cfg.prefix_cap:
            self.cfg.prefix_cap *= 2
        cap = self.cfg.prefix_cap
        w = config.words
        cols = []
        for j in range(w):
            col = np.full((self.ndev, cap), 0xFFFFFFFF, np.uint32)
            for d in range(self.ndev):
                part = keys[d * per: (d + 1) * per, j]
                col[d, : part.shape[0]] = part
            cols.append(self._put_rows(col))
        ccol = np.zeros((self.ndev, cap), np.int32)
        big = 1 << 20
        cc = np.where(cnt > big, big + (cnt & (big - 1)), cnt).astype(np.int32)
        for d in range(self.ndev):
            part = cc[d * per: (d + 1) * per]
            ccol[d, : part.shape[0]] = part
        cols.append(self._put_rows(ccol))
        self.prefix = tuple(cols)
        if "tail" in z and z["tail"].shape[0]:
            self._buf.append(z["tail"].astype(np.uint8))
        self.stats["windows_processed"] = int(z["windows_processed"])
        return self
