"""Streaming canonical k-mer counter on the sort-based device backend.

The flagship pipeline (see ops/sortcount.py for the kernel design): the
host packs the encoded code stream to 2 bits/base plus a sparse
separator-index list, ships one superbatch per transfer, and the device
runs ONE fused "superstep" per superbatch — unpack -> canonical window
keys -> merge with the compacted distinct prefix — in a single
dispatch.  The host packs and ships superbatch s+1 while superstep s
runs and only then blocks on superstep s's distinct count.

Same user surface as models.counter.KmerCounter (the probe-table
backend): add_codes/finish/count_file/as_dict/write_output/find.
Replaces the reference's parser-functor pipelines
(reference: include/parallel_parser.hpp) with one device consumer.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import jax
import jax.numpy as jnp

from ..io import codebuf
from ..io import fastio
from ..io import reader as io_reader
from ..ops import sortcount
from ..utils import codec


@dataclasses.dataclass
class SortCounterConfig:
    k: int
    mode: int = 2                  # 0 = plain, 2 = kaarme (output clipping)
    min_abundance: int = 2
    batch_windows: int = 1 << 23   # windows per device batch (power of two)
    rows: int = 1 << 12            # 2D working layout rows (power of two <= batch)
    merge_every: int = 2           # retained for config compat; the fused
                                   # superstep merges once per superbatch
    superbatch_batches: int = 4    # device batches fused per superstep; the
                                   # superstep's merge sorts superbatch+prefix
                                   # rows, so this also caps peak HBM (~32M
                                   # windows + prefix x ~10 generations)
    prefix_cap: int = 1 << 22      # distinct-record prefix capacity; grows on demand
    transfer_group: int = 4        # superbatches shipped per host->device copy
    min_slots: int = 0             # reference -s compat: initial prefix sizing
    winkeys: str = "codes"         # window-key extraction: "codes" (per-
                                   # character planes) or "packed" (direct
                                   # shift-or from the packed words)

    def __post_init__(self):
        sortcount.check_winkeys(self.winkeys)
        if self.k < 2:
            raise ValueError("k must be >= 2")
        if self.mode not in (0, 1, 2):
            raise ValueError("mode must be 0, 1 or 2")
        if self.batch_windows & (self.batch_windows - 1):
            raise ValueError("batch_windows must be a power of two")
        if self.rows & (self.rows - 1) or self.rows > self.batch_windows:
            raise ValueError("rows must be a power of two <= batch_windows")
        if self.batch_windows < 32:
            raise ValueError("batch_windows must be >= 32")
        if self.min_slots:
            need = 1 << (int(self.min_slots) - 1).bit_length()
            self.prefix_cap = max(self.prefix_cap, need)

    @property
    def words(self) -> int:
        return codec.words_per_kmer(self.k)

    @property
    def superstep_windows(self) -> int:
        return self.batch_windows * self.superbatch_batches

    def tail_windows(self, r: int) -> int:
        """Smallest multiple of ``rows`` that holds r windows — bounds
        padding on the final (tail) superstep to < one row-block."""
        return min(-(-max(r, 1) // self.rows) * self.rows, self.superstep_windows)

    def sep_budget(self, n: int, n_seps: int = -1) -> int:
        """Sparse separator-index capacity shipped per superstep.
        Two static sizes keep compile variants bounded: n/128 (read
        length >= 127 — typical short-read data; 25% less transfer than
        n/32) and n/32 (read length >= 31); denser separator streams
        fall back to the dense-bitmap superstep variant."""
        small, big = max(n // 128, 32), max(n // 32, 32)
        if 0 <= n_seps <= small:
            return small
        return big


class _Done:
    """Future-alike wrapping an already-resolved prep (re-queued when a
    shape boundary splits a transfer group)."""

    def __init__(self, value):
        self._v = value

    def result(self):
        return self._v


class SortKmerCounter:
    """Streaming counter: sorted runs + compacted distinct prefix."""

    def __init__(self, config: SortCounterConfig):
        self.cfg = config
        self.prefix = sortcount.make_store(config.prefix_cap, config.words)
        self.n_distinct = 0
        self.n_used = 0     # prefix rows occupied (the superstep's nd_used)
        self._buf = codebuf.CodeBuffer()  # encoded codes awaiting superbatches
        # in-flight supersteps: deque of (new_prefix, nd_handle, replay),
        # replay = (packed_d, sep_d, n, dense, old_prefix).  Dispatch is
        # OPTIMISTIC: superstep s+1 chains on s's (unverified) output
        # prefix on device; capacity verification trails behind by up to
        # _max_inflight steps (waiting on each nd before the next
        # dispatch would serialize host and device).  On overflow every
        # trailing superstep is replayed from its kept inputs at the
        # grown capacity.
        import collections
        import concurrent.futures as _cf

        self._inflight = collections.deque()
        self._max_inflight = 2
        self._delta_max = None   # max verified distinct growth per superstep
        # single-worker pool: superbatch s+1's host pack overlaps
        # superstep s's device compute
        self._pool = _cf.ThreadPoolExecutor(max_workers=1)
        self._prepped = []   # packed superbatches awaiting transfer
        self._ready = None   # transferred superbatch awaiting dispatch
        self.stats = {
            "windows_processed": 0,
            "batches": 0,
            "compactions": 0,
            "grow_events": 0,
            "build_seconds": 0.0,
            "write_seconds": 0.0,
        }

    # -- streaming ---------------------------------------------------------

    def add_codes(self, codes: np.ndarray):
        self._buf.append(codes)
        sb = self.cfg.superstep_windows
        need = sb + self.cfg.k - 1
        while len(self._buf) >= need:
            # zero-copy view in the common (large-chunk) case; the k-1
            # overlap is cursor arithmetic, not a carry copy
            self._process_stream(self._buf.take(need, sb), sb)

    def finish(self):
        """Process the remaining tail (padded with separators) and drain
        the in-flight superstep."""
        stream = self._buf.take_all()
        if stream.shape[0] >= self.cfg.k:
            self._process_stream(stream, stream.shape[0] - self.cfg.k + 1)
        self._launch(final=True)
        self._drain()

    def count_codes(self, codes: np.ndarray):
        self.add_codes(np.asarray(codes, np.uint8))
        self.finish()
        return self

    def count_file(self, path: str, chunk_bytes: int = io_reader.DEFAULT_CHUNK_BYTES,
                   prefetch: int = 4):
        chunks = io_reader.CodeChunkReader(path, chunk_bytes=chunk_bytes)
        if prefetch:
            chunks = io_reader.PrefetchingReader(chunks, depth=prefetch)
        for codes in chunks:
            self.add_codes(codes)
        self.finish()
        return self

    # -- device steps ------------------------------------------------------

    # Pipeline ordering: device_put ISSUES asynchronously, so a copy
    # issued BEFORE a compute dispatch can ride the link while that
    # compute runs (whether CUDA streams overlap them here is not yet
    # measured — ROADMAP S5).  So per transfer group:
    #   worker thread:  pack g+1 (numpy/C++, overlaps everything)
    #   main thread:    issue device_put g+1 -> drain/dispatch group g
    # which keeps every copy strictly AHEAD of the compute it overlaps.

    def _process_stream(self, stream: np.ndarray, n_windows: int):
        self._prepped.append(
            self._pool.submit(self._prepare, stream, n_windows))
        # steady state: keep one packed superbatch queued so its
        # transfer can be issued right after this round's dispatch
        if len(self._prepped) > 1:
            self._launch(final=False)

    def _prepare(self, stream: np.ndarray, n_windows: int):
        """Worker-thread half: pad, 2-bit pack, build separator stream
        (host arrays only — the transfer is issued by the main thread
        after the next dispatch)."""
        cfg = self.cfg
        k = cfg.k
        n = n_windows if n_windows == cfg.superstep_windows \
            else cfg.tail_windows(n_windows)
        need = n + k - 1
        if stream.shape[0] < need:
            stream = np.concatenate(
                [stream, np.full(need - stream.shape[0], codec.SEP, np.uint8)]
            )
        stream = stream[:need]
        packed, _maskw = fastio.pack_stream(stream)
        seps = np.flatnonzero(stream >= 4).astype(np.uint32)
        budget = cfg.sep_budget(n, seps.shape[0])
        if seps.shape[0] <= budget:
            sep = np.full(budget, need, np.uint32)  # out-of-range pad
            sep[: seps.shape[0]] = seps
            dense = False
        else:
            sep, dense = _maskw, True
        return packed, sep, n, dense, n_windows

    def _take_group(self, final: bool):
        """Pop a group of packed superbatches for ONE transfer
        (``transfer_group`` superbatches ride per copy).  Only
        same-shape superbatches group together (full-size, same
        separator representation); the group is padded to the full
        group width so every chunk compiles to one program."""
        g = self.cfg.transfer_group
        avail = len(self._prepped)
        if avail == 0 or (avail < g and not final):
            return None
        preps = [self._prepped.pop(0).result()]
        n0, dense0 = preps[0][2], preps[0][3]
        while (len(preps) < g and self._prepped):
            nxt = self._prepped.pop(0).result()
            if nxt[2] != n0 or nxt[3] != dense0:
                self._prepped.insert(0, _Done(nxt))  # re-queue, next group
                break
            preps.append(nxt)
        k = self.cfg.k
        need = n0 + k - 1
        nwords, mwords = (need + 15) // 16, (need + 31) // 32
        G = g if n0 == self.cfg.superstep_windows else len(preps)
        if dense0:
            chunk = np.full(G * mwords, 0xFFFFFFFF, np.uint32)
            for i, p in enumerate(preps):
                chunk[i * mwords: i * mwords + p[1].shape[0]] = p[1]
            sep_h = chunk
        else:
            budget = max(p[1].shape[0] for p in preps)
            sep_h = np.full((G, budget), need, np.uint32)
            for i, p in enumerate(preps):
                sep_h[i, : p[1].shape[0]] = p[1]
        packed_h = np.zeros(G * nwords, np.uint32)
        for i, p in enumerate(preps):
            packed_h[i * nwords: i * nwords + p[0].shape[0]] = p[0]
        packed_d = jax.device_put(jnp.asarray(packed_h))
        sep_d = jax.device_put(jnp.asarray(sep_h))
        metas = [(i * nwords, i, p[2], p[3], p[4])
                 for i, p in enumerate(preps)]
        return packed_d, sep_d, metas

    def _launch(self, final: bool):
        """Main-thread half: dispatch the transferred group (if any),
        then issue the next group's transfer so the copy rides while
        the dispatched supersteps compute."""
        t0 = time.perf_counter()
        if self._ready is None:
            # pipeline warm-up: first transfer has nothing to overlap
            self._ready = self._take_group(final)
        while self._ready is not None:
            packed_d, sep_d, metas = self._ready
            # issue the NEXT group's transfer BEFORE dispatching this
            # group's supersteps: device_put returns early and the copy
            # overlaps the compute dispatched below (see the pipeline-
            # ordering note above)
            self._ready = self._take_group(final)
            for wstart, srow, n, dense, n_windows in metas:
                self._drain(keep=self._max_inflight)
                self._dispatch(packed_d, sep_d, n, dense, wstart, srow)
                self.stats["batches"] += 1
                self.stats["windows_processed"] += n_windows
            if not final:
                break
        self.stats["build_seconds"] += time.perf_counter() - t0

    # -- live-prefix sizing --------------------------------------------------
    # The superstep's merge mass is (prefix length + n): passing the full
    # allocated capacity every superstep wastes sort/merge/stream work
    # whenever the live distinct set is much smaller (early stream, or a
    # user-oversized -s).  Each dispatch therefore slices/pads the prefix
    # to a working size from a small step ladder ({2^m, 3*2^m} — bounded
    # compile variants) covering the verified fill plus headroom for the
    # optimistic in-flight window.  Too-small guesses are caught by the
    # existing overflow verification and replayed at a larger size.

    @staticmethod
    def _step_up(x: int) -> int:
        """Smallest ladder value ({2^m, 3*2^m}, m >= 12) >= x."""
        return sortcount.next_store_size(x)

    def _eff_for_dispatch(self, n: int) -> int:
        cap = self.cfg.prefix_cap
        if cap <= (1 << 12):        # below the ladder floor: no sizing
            return cap
        delta = self._delta_max if self._delta_max is not None else n
        target = self.n_used + (self._max_inflight + 1) * max(delta, n // 16)
        # coarse ladder: above 2^22 every slicing step is a fresh merge
        # compile — on growing stores fewer sizes trade sort mass for
        # compiles
        eff = min(sortcount.next_store_size(target, coarse=True), cap)
        if self._inflight:
            # unverified in-flight outputs may hold up to the current
            # allocated length of live rows — never slice below it
            eff = max(eff, self.prefix[0].shape[0])
        return eff

    def _sized_prefix(self, eff: int):
        cur = self.prefix[0].shape[0]
        if cur == eff:
            return self.prefix
        if cur > eff:
            return tuple(c[:eff] for c in self.prefix)
        pad = eff - cur
        return tuple(
            jnp.concatenate([c, sortcount.dead_fill((pad,), c.dtype)])
            for c in self.prefix
        )

    def _superstep_kwargs(self) -> dict:
        """Extra keyword args threaded into the counting supersteps
        (the Bloom-prefiltered subclass passes its BF2 here)."""
        return {}

    def _dispatch(self, packed_d, sep_d, n: int, dense: bool,
                  wstart: int = 0, srow: int = 0):
        cfg = self.cfg
        rows = min(cfg.rows, n)
        eb = sortcount.embed_bits(cfg.k)
        extra = self._superstep_kwargs()
        prefix_in = self._sized_prefix(self._eff_for_dispatch(n))
        wk = cfg.winkeys
        # count embedding: stored counts are always < 2^21 (post-sum
        # modular clamp in ops/sortcount.py), so 21 free trailing-word
        # bits suffice, independent of merge size
        if eb >= 21:
            new_prefix, nd = sortcount.superstep_embedded(
                packed_d, sep_d, prefix_in, wstart, srow,
                k=cfg.k, n=n, rows=rows,
                ebits=eb, dense=dense, winkeys=wk, **extra)
        else:
            new_prefix, nd = sortcount.superstep_plain(
                packed_d, sep_d, prefix_in, wstart, srow,
                k=cfg.k, n=n, rows=rows,
                dense=dense, winkeys=wk, **extra)
        self._inflight.append(
            (new_prefix, nd,
             (packed_d, sep_d, n, dense, wstart, srow, prefix_in)))
        # optimistic: later supersteps chain on this (unverified) output
        self.prefix = new_prefix

    def _drain(self, keep: int = 0):
        """Verify in-flight supersteps down to ``keep`` outstanding:
        accept each prefix, or grow the capacity and replay the
        overflowing superstep AND everything dispatched after it (their
        inputs stay live in the deque until verified)."""
        while len(self._inflight) > keep:
            new_prefix, nd_h, replay = self._inflight.popleft()
            nd_exact, nd = (int(x) for x in np.asarray(nd_h))
            cap_used = replay[-1][0].shape[0]   # this dispatch's prefix size
            if nd <= cap_used:
                delta = nd_exact - self.n_distinct
                if delta > 0:
                    self._delta_max = max(self._delta_max or 0, delta)
                self.n_distinct = nd_exact
                self.n_used = nd
                self.stats["compactions"] += 1
                continue
            # grow-and-replay: pick the next working size that fits (plus
            # headroom), re-pad the still-live pre-overflow prefix, and
            # re-run this superbatch plus every optimistically-chained one
            # after it.  nd counts only records the sliced output KEPT, so
            # use the superstep input mass as the upper bound for resizing.
            replays = [replay] + [r for (_, _, r) in self._inflight]
            self._inflight.clear()
            n_over = replay[2]
            bound = min(cap_used + n_over,
                        2 * max(nd, cap_used))   # growth ceiling per retry
            new_eff = self._step_up(bound)
            self._delta_max = max(self._delta_max or 0, new_eff - self.n_used)
            if new_eff > self.cfg.prefix_cap:
                self.cfg.prefix_cap = new_eff
                self.stats["grow_events"] += 1
            old_prefix = replay[-1]
            pad = new_eff - old_prefix[0].shape[0]
            self.prefix = tuple(
                jnp.concatenate([col, sortcount.dead_fill((pad,), col.dtype)])
                for col in old_prefix
            )
            for packed_d, sep_d, n, dense, wstart, srow, _old in replays:
                self._dispatch(packed_d, sep_d, n, dense, wstart, srow)
                self._drain(keep=0)  # verify each replay synchronously

    def _merge(self):
        """Drain any in-flight device work (the superstep merges as it
        goes, so this is just the pipeline sync point)."""
        self._drain()

    # -- output ------------------------------------------------------------

    def _clip(self, counts: np.ndarray) -> np.ndarray:
        if self.cfg.mode == 0:
            return counts & 0xFFFF        # uint16 wrap, reference plain table
        return np.minimum(counts, 16383)  # 14-bit saturation, kaarme table

    def _flush(self):
        """Process buffered host-side input (pending chunks + carry) so
        no partial reads are silently dropped by dump/save/find: the
        stream-so-far is treated as complete (windows that WOULD span a
        dump boundary and later input are not formed — same semantics as
        the reference's single-shot run ending)."""
        if len(self._buf):
            self.finish()

    def dump(self):
        """(keys (N, W) uint32 sorted, counts (N,) int64) of all distinct
        k-mers, before abundance filtering / clipping.  Flushes buffered
        input first."""
        self._flush()
        self._merge()
        return self._dump_device()

    def _dump_device(self):
        """Device store -> host (keys, counts), WITHOUT flushing host
        buffers (callers must have drained in-flight device work)."""
        nd = self.n_used
        if not nd:
            return (np.zeros((0, self.cfg.words), np.uint32),
                    np.zeros((0,), np.int64))
        keys = np.stack(
            [np.asarray(jax.device_get(c[:nd])) for c in self.prefix[:-1]], axis=1
        )
        cnt = np.asarray(jax.device_get(self.prefix[-1][:nd])).astype(np.int64)
        return keys, cnt

    def as_dict(self) -> dict:
        tk, cn = self.dump()
        cn = self._clip(cn)
        keep = cn >= self.cfg.min_abundance
        names = codec.unpack_kmers(tk[keep], self.cfg.k) if keep.any() else []
        return dict(zip(names, cn[keep].tolist()))

    def write_output(self, path: str) -> int:
        """`KMER COUNT` lines, canonical k-mers in sorted order (the
        reference emits table order and its comparator sorts — reference:
        source/kmer_hash_table.cpp:4318-4524, pytools/compare_outputs.py)."""
        t0 = time.perf_counter()
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
        self.stats["write_seconds"] += time.perf_counter() - t0
        return int(n)

    # -- queries -----------------------------------------------------------

    def find(self, kmers) -> list:
        """Counts for query k-mer strings (0 if absent, -1 if malformed)."""
        if isinstance(kmers, str):
            kmers = [kmers]
        tk, cn = self.dump()
        w = codec.words_per_kmer(self.cfg.k)   # k-mer words (dump format),
        # NOT cfg.words: subclasses may keep a differently-shaped store
        packed = np.zeros((len(kmers), w), np.uint32)
        ok = np.ones(len(kmers), bool)
        for i, s in enumerate(kmers):
            if len(s) != self.cfg.k or any(ch not in "ACGTacgt" for ch in s):
                ok[i] = False
                continue
            packed[i] = codec.pack_kmer(codec.canonical(s.upper()))
        out = self._clip(sortcount.lookup_sorted(tk, cn, packed))
        return [int(c) if good else -1 for c, good in zip(out, ok)]

    # -- checkpoint / resume ----------------------------------------------
    # (the reference is single-shot with no persistence — SURVEY.md
    # section 5; this framework adds snapshot/restore so long counting
    # jobs survive preemption)

    def save(self, path: str):
        """Snapshot the merged distinct set + config to an .npz file.

        The unprocessed host tail (buffered codes shorter than a
        superbatch) is saved VERBATIM and restored by ``load`` — NOT
        flushed as if the stream had ended — so windows spanning the
        checkpoint boundary are neither lost nor double-counted
        (matching ShardedSortCounter.save's tail contract)."""
        tail = self._buf.take_all()
        self._launch(final=True)   # process already-prepared superbatches
        self._drain()
        keys, cnt = self._dump_device()
        nd = keys.shape[0]
        cols = {f"col{i}": keys[:, i] for i in range(self.cfg.words)}
        cols[f"col{self.cfg.words}"] = cnt.astype(np.int32)
        np.savez_compressed(
            path, n_distinct=nd, k=self.cfg.k, mode=self.cfg.mode,
            min_abundance=self.cfg.min_abundance,
            windows_processed=self.stats["windows_processed"],
            tail=tail, **cols,
        )
        # the in-memory counter keeps its exact pre-save state
        self._buf.append(tail)

    @classmethod
    def load(cls, path: str, config: "SortCounterConfig | None" = None):
        """Restore a counter from ``save`` output; counting can resume."""
        z = np.load(path)
        k = int(z["k"])
        if config is None:
            config = SortCounterConfig(
                k=k, mode=int(z["mode"]), min_abundance=int(z["min_abundance"]),
            )
        elif config.k != k:
            raise ValueError(f"checkpoint is for k={k}, config has k={config.k}")
        self = cls(config)
        nd = int(z["n_distinct"])
        while nd > self.cfg.prefix_cap:
            self.cfg.prefix_cap *= 2
        cap = self.cfg.prefix_cap
        cols = []
        for i in range(config.words + 1):
            host = z[f"col{i}"]
            if host.dtype == np.int32 or host.dtype == np.int64:
                # count column: re-apply the modular clamp so checkpoints
                # written before the stored-count invariant existed still
                # satisfy counts < 2^21
                host = host.astype(np.int64)
                big = 1 << 20
                host = np.where(host > big, big + (host & (big - 1)), host)
                full = np.zeros(cap, np.int32)
                full[:nd] = host.astype(np.int32)
            else:
                full = np.full(cap, 0xFFFFFFFF, np.uint32)  # sentinel padding
                full[:nd] = host
            cols.append(jnp.asarray(full))
        self.prefix = tuple(cols)
        self.n_distinct = nd
        self.n_used = nd
        self.stats["windows_processed"] = int(z["windows_processed"])
        if "tail" in z.files:  # unprocessed boundary codes (see save)
            self._buf.append(z["tail"].astype(np.uint8))
        return self

    # -- diagnostics -------------------------------------------------------

    def occupancy(self) -> tuple:
        self._merge()
        return self.n_distinct, self.cfg.prefix_cap
