"""Multi-device (and multi-host) sharded counting.

The reference has no distribution at all — its parallelism is N CPU
threads CAS-ing one shared table (SURVEY.md section 2.2).  The device
scale-out keeps that table as ONE logical array sharded over a device
mesh:

- mesh axis ``d``: the count table (keys rows + counts) is partitioned by
  *hash prefix* — slot bits [shard_log2, cap_log2) pick the owner device,
  the low bits address within the owner's shard;
- read tiles are data-parallel over ``d``: every device extracts windows
  from its own shard of the input stream;
- each window is routed to its owner via ``jax.lax.all_to_all`` as a
  (key words, amount) record over the device interconnect; the owner
  runs the same batched probe/insert kernel locally (ops/table.py).

Within a shard the probe sequence uses only low slot bits, so shards are
independent open-addressing tables and single-device results equal
multi-device results as count multisets.

The per-destination routing capacity is the full local window count, so
routing can never drop records (skew-proof); a future optimization is
local sort-dedup + 2x-slack capacity to cut interconnect volume.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import table as table_ops
from ..ops.hashing import hash_words, hash_words_np
from ..ops.windows import windows_with_hash
from ..utils import codec
from ..utils.mathutils import capacity_log2
from ..models.tiling import TileBatcher


def make_mesh(n_devices: int = 0, platform: str | None = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices of ``platform``
    (default: JAX's default backend; 0 = all of them).  Raises when the
    platform has fewer devices — pass platform="cpu" explicitly for
    virtual-device runs."""
    devs = jax.devices(platform) if platform else jax.devices()
    n = n_devices or len(devs)
    if n & (n - 1):
        raise ValueError(f"device count must be a power of two, got {n}")
    if len(devs) < n:
        raise ValueError(f"need {n} devices, have {len(devs)}")
    return Mesh(np.asarray(devs[:n]), ("d",))


@dataclasses.dataclass
class ShardedCounterConfig:
    k: int
    min_slots: int = 1 << 22
    mode: int = 2
    min_abundance: int = 2
    tile: int = 1 << 14
    batch_tiles: int = 64          # must be a multiple of the device count
    max_probes: int = 64

    @property
    def words(self) -> int:
        return codec.words_per_kmer(self.k)


def _route_records(keys, valid, amount, tkeys, counts, *, cap_log2: int,
                   shard_log2: int, max_probes: int):
    """Per-device routing + insert core (runs under shard_map).

    keys:   tuple of W uint32 [N] local packed canonical words
    valid:  [N] bool
    amount: [N] int32 contribution per record
    tkeys:  (C/ndev, W) local table shard
    counts: (C/ndev,)   local counts shard

    Returns (tkeys, counts, overflow, pend_records) where pend_records
    is the (ndev*N, W+1) receive buffer with non-pending rows zeroed —
    the exact records that did not land, so a grow-and-retry re-inserts
    only those (reference contrast: table full is exit(1),
    source/kmer_hash_table.cpp:2553-2556).
    """
    ndev = jax.lax.axis_size("d")
    n = valid.shape[0]
    w = len(keys)

    slot_global = hash_words(keys) & jnp.uint32((1 << cap_log2) - 1)
    owner = (slot_global >> jnp.uint32(shard_log2)).astype(jnp.int32)

    # position of each record within its owner's bucket
    onehot = (owner[:, None] == jnp.arange(ndev, dtype=jnp.int32)[None, :]) & valid[:, None]
    pos = jnp.cumsum(onehot.astype(jnp.int32), axis=0) - 1
    pos = jnp.take_along_axis(pos, owner[:, None], axis=1)[:, 0]

    cap = n  # full capacity: routing can never drop (skew-proof)
    send = jnp.zeros((ndev * cap, w + 1), jnp.uint32)
    idx = jnp.where(valid, owner * cap + pos, ndev * cap)
    record = jnp.stack(list(keys) + [amount.astype(jnp.uint32)], axis=1)
    send = send.at[idx].set(record, mode="drop")
    send = send.reshape(ndev, cap, w + 1)

    recv = jax.lax.all_to_all(send, "d", split_axis=0, concat_axis=0, tiled=False)
    recv = recv.reshape(ndev * cap, w + 1)

    rkeys = tuple(recv[:, j] for j in range(w))
    ramount = recv[:, w].astype(jnp.int32)
    rvalid = ramount > 0
    rh = hash_words(rkeys)

    tkeys, counts, pending = table_ops.insert(
        tkeys, counts, rkeys, rvalid, rh, amount=ramount, max_probes=max_probes
    )
    overflow = jax.lax.psum(jnp.sum(pending.astype(jnp.int32)), "d")
    pend_records = recv * pending[:, None].astype(jnp.uint32)
    return tkeys, counts, overflow, pend_records


def _routed_insert(tiles, tkeys, counts, *, k: int, cap_log2: int,
                   shard_log2: int, max_probes: int):
    """Window-extraction front end over :func:`_route_records`."""
    keys, valid, _h = windows_with_hash(tiles, k)
    amount = jnp.ones((valid.shape[0],), jnp.int32)
    return _route_records(keys, valid, amount, tkeys, counts,
                          cap_log2=cap_log2, shard_log2=shard_log2,
                          max_probes=max_probes)


def _routed_insert_records(records, tkeys, counts, *, words: int,
                           cap_log2: int, shard_log2: int, max_probes: int):
    """Record front end: ``records`` is (N/ndev, W+1) local rows of
    (key words..., amount) — used by grow-and-retry and checkpoint
    restore."""
    keys = tuple(records[:, j] for j in range(words))
    amount = records[:, words].astype(jnp.int32)
    return _route_records(keys, amount > 0, amount, tkeys, counts,
                          cap_log2=cap_log2, shard_log2=shard_log2,
                          max_probes=max_probes)


class ShardedKmerCounter:
    """Same pipeline surface as models.KmerCounter, over a device mesh."""

    def __init__(self, config: ShardedCounterConfig, mesh: Mesh | None = None):
        self.cfg = config
        self.mesh = mesh if mesh is not None else make_mesh()
        self.ndev = int(self.mesh.devices.size)
        if config.batch_tiles % self.ndev:
            raise ValueError("batch_tiles must be a multiple of the device count")
        self.cap_log2 = max(capacity_log2(config.min_slots),
                            (self.ndev - 1).bit_length() + 1)
        self._alloc_table()
        self._batcher = TileBatcher(config.k, config.tile, config.batch_tiles)
        self.stats = {"windows_processed": 0, "batches": 0, "grow_events": 0}
        self._build_steps()

    def _alloc_table(self):
        """Fresh zeroed table shards at the current capacity."""
        self.shard_log2 = self.cap_log2 - (self.ndev - 1).bit_length()
        c = 1 << self.cap_log2
        kspec = NamedSharding(self.mesh, P("d", None))
        cspec = NamedSharding(self.mesh, P("d"))
        self.tkeys = jax.device_put(
            jnp.zeros((c, self.cfg.words), jnp.uint32), kspec)
        self.counts = jax.device_put(jnp.zeros((c,), jnp.int32), cspec)

    def _build_steps(self):
        """(Re)jit the shard_map steps for the current capacity."""
        config = self.cfg
        body = partial(
            _routed_insert,
            k=config.k,
            cap_log2=self.cap_log2,
            shard_log2=self.shard_log2,
            max_probes=config.max_probes,
        )
        out = (P("d", None), P("d"), P(), P("d", None))
        self._step = jax.jit(jax.shard_map(
            body, mesh=self.mesh,
            in_specs=(P("d", None), P("d", None), P("d")),
            out_specs=out,
        ), donate_argnums=(1, 2))
        rbody = partial(
            _routed_insert_records,
            words=config.words,
            cap_log2=self.cap_log2,
            shard_log2=self.shard_log2,
            max_probes=config.max_probes,
        )
        self._records_step = jax.jit(jax.shard_map(
            rbody, mesh=self.mesh,
            in_specs=(P("d", None), P("d", None), P("d")),
            out_specs=out,
        ), donate_argnums=(1, 2))

    # -- streaming (same surface as KmerCounter) ---------------------------

    def add_codes(self, codes: np.ndarray):
        for tiles in self._batcher.add(codes):
            self._flush(tiles)

    def finish(self):
        for tiles in self._batcher.finish():
            self._flush(tiles)

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

    def _flush(self, tiles_np: np.ndarray):
        tiles = jax.device_put(
            jnp.asarray(tiles_np), NamedSharding(self.mesh, P("d", None))
        )
        self.tkeys, self.counts, overflow, pend = self._step(
            tiles, self.tkeys, self.counts)
        if int(overflow):
            self._grow_and_retry(pend)
        self.stats["batches"] += 1
        self.stats["windows_processed"] += tiles_np.shape[0] * self.cfg.tile

    def _grow_and_retry(self, pend):
        """Double the global capacity, rebuild the table from its own
        live records, and re-insert the pending (unplaced) records —
        the sharded analogue of the single-device grow-and-retry
        (reference contrast: exit(1) on full,
        source/kmer_hash_table.cpp:2553-2556)."""
        w = self.cfg.words
        pend_np = np.asarray(jax.device_get(pend)).reshape(-1, w + 1)
        pend_np = pend_np[pend_np[:, w] > 0]
        live_tk, live_cn = self.dump()
        while True:
            self.cap_log2 += 1
            self.stats["grow_events"] += 1
            self._alloc_table()
            self._build_steps()
            recs = np.concatenate(
                [np.concatenate(
                    [live_tk, live_cn.astype(np.uint32)[:, None]], axis=1),
                 pend_np], axis=0)
            overflow, pend = self._insert_records(recs)
            if not overflow:
                return
            pend_np = np.asarray(jax.device_get(pend)).reshape(-1, w + 1)
            pend_np = pend_np[pend_np[:, w] > 0]
            live_tk, live_cn = self.dump()

    def _insert_records(self, recs: np.ndarray):
        """Insert host-side (key words..., amount) uint32 rows through
        the routed device path (pads to a device multiple)."""
        w = self.cfg.words
        n = recs.shape[0]
        padded = -(-max(n, 1) // self.ndev) * self.ndev
        if padded != n:
            recs = np.concatenate(
                [recs, np.zeros((padded - n, w + 1), np.uint32)], axis=0)
        recs_d = jax.device_put(
            jnp.asarray(recs.astype(np.uint32)),
            NamedSharding(self.mesh, P("d", None)))
        self.tkeys, self.counts, overflow, pend = self._records_step(
            recs_d, self.tkeys, self.counts)
        return int(overflow), pend

    # -- output --------------------------------------------------------------

    def _clip(self, counts: np.ndarray) -> np.ndarray:
        if self.cfg.mode == 0:
            return counts & 0xFFFF
        return np.minimum(counts, 16383)

    def dump(self):
        cn = np.asarray(self.counts)
        occ = cn > 0
        return np.asarray(self.tkeys)[occ], cn[occ]

    def as_dict(self) -> dict:
        tk, cn = self.dump()
        cn = self._clip(cn)
        keep = cn >= self.cfg.min_abundance
        names = codec.unpack_kmers(tk[keep], self.cfg.k) if keep.any() else []
        return dict(zip(names, cn[keep].tolist()))

    def occupancy(self):
        cn = np.asarray(self.counts)
        return int((cn > 0).sum()), int(cn.shape[0])

    # -- checkpoint / resume -------------------------------------------------
    # (the reference is single-shot with no persistence — SURVEY.md
    # section 5; snapshots let long sharded jobs survive preemption)

    def save(self, path: str):
        """Snapshot live (key, count) records + the not-yet-processed
        tail bytes, so windows spanning the checkpoint boundary are
        neither lost nor double-counted on resume.  The live counter is
        left untouched."""
        tk, cn = self.dump()
        np.savez_compressed(
            path, kind="sharded_table", k=self.cfg.k, mode=self.cfg.mode,
            min_abundance=self.cfg.min_abundance, keys=tk,
            counts=cn.astype(np.int64), tail=self._batcher._buf,
            windows_processed=self.stats["windows_processed"],
        )

    @classmethod
    def load(cls, path: str, config: "ShardedCounterConfig | None" = None,
             mesh: Mesh | None = None):
        """Restore from ``save`` output onto a (possibly different-size)
        mesh; counting can resume."""
        z = np.load(path)
        k = int(z["k"])
        if config is None:
            config = ShardedCounterConfig(
                k=k, mode=int(z["mode"]),
                min_abundance=int(z["min_abundance"]))
        elif config.k != k:
            raise ValueError(f"checkpoint is for k={k}, config has k={config.k}")
        self = cls(config, mesh)
        keys = z["keys"].astype(np.uint32)
        cnt = z["counts"].astype(np.uint32)
        if keys.shape[0]:
            recs = np.concatenate([keys, cnt[:, None]], axis=1)
            overflow, pend = self._insert_records(recs)
            if overflow:
                self._grow_and_retry(pend)
        if "tail" in z and z["tail"].shape[0]:
            self._batcher._buf = z["tail"].astype(np.uint8)
        self.stats["windows_processed"] = int(z["windows_processed"])
        return self

    # -- queries ---------------------------------------------------------------

    def find(self, kmers) -> list:
        """Host-side point lookups: route by hash prefix, emulate the
        shard-local probe sequence in NumPy (bit-for-bit the device hash)."""
        if isinstance(kmers, str):
            kmers = [kmers]
        tk = np.asarray(self.tkeys)
        cn = np.asarray(self.counts)
        shard_slots = 1 << self.shard_log2
        out = []
        for s in kmers:
            if len(s) != self.cfg.k or any(ch not in "ACGTacgt" for ch in s):
                out.append(-1)
                continue
            packed = codec.pack_kmer(codec.canonical(s.upper()))
            h = int(hash_words_np(tuple(np.uint32(x) for x in packed)))
            owner = (h & ((1 << self.cap_log2) - 1)) >> self.shard_log2
            base = owner * shard_slots
            cnt = 0
            for i in range(self.cfg.max_probes):
                local = (h + (i * (i + 1) // 2)) % shard_slots
                slot = base + local
                if cn[slot] <= 0:
                    break
                if (tk[slot] == packed).all():
                    cnt = int(cn[slot])
                    break
            out.append(int(self._clip(np.asarray([cnt]))[0]))
        return out
