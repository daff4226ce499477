"""Two-pass Bloom-prefiltered counting pipeline.

Rebuild of the reference's `-b` mode (reference: main.cpp:395-510):

pass 1  stream the whole input, push every canonical k-mer's 64-bit root
        hash through the two-stage Bloom filter (BF1 = seen once,
        BF2 = seen twice);
sizing  table min_slots = 2 * new_in_second (reference: main.cpp:454);
squeeze BF1 is dropped, halving filter memory before counting
        (reference: include/mybitarray.hpp:127-162);
pass 2  stream the input again and count only k-mers whose bits are all
        set in BF2 (reference: include/parallel_parser.hpp:2436-2454) —
        singletons never enter the table.

The root hash here is a 64-bit mix of the packed canonical words (two
independent 32-bit mixes) instead of the reference's 2^54 rolling
polynomial (reference: main.cpp:433-435): windows are materialized in
parallel on the device, so rolling state buys nothing and the stronger
mix feeds double hashing directly.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..io import reader as io_reader
from ..ops import bloom as bloom_ops
from ..ops import table as table_ops
from ..ops.hashing import hash_words64
from ..ops.windows import windows_with_hash
from ..utils.mathutils import bloom_sizing
from .counter import CounterConfig, KmerCounter
from .tiling import TileBatcher


@dataclasses.dataclass
class BloomCounterConfig:
    k: int
    expected_unique: int
    fpr: float = 0.01
    mode: int = 2
    min_abundance: int = 2
    tile: int = 1 << 14
    batch_tiles: int = 64
    max_probes: int = 64


@partial(jax.jit, static_argnames=("k", "hfn"), donate_argnums=(0, 1))
def _bloom_pass1_step(bf1, bf2, tiles, k: int, hfn: int):
    keys, valid, _ = windows_with_hash(tiles, k)
    r1, r2 = hash_words64(keys)
    return bloom_ops.insert_batch(bf1, bf2, r1, r2, valid, hfn)


@partial(jax.jit, static_argnames=("k", "hfn", "max_probes"))
def _bloom_count_step(tkeys, counts, bf2, tiles, k: int, hfn: int, max_probes: int):
    keys, valid, h = windows_with_hash(tiles, k)
    r1, r2 = hash_words64(keys)
    in2 = bloom_ops.contains(bf2, r1, r2, hfn)
    valid = valid & in2
    tkeys, counts, pending = table_ops.insert(
        tkeys, counts, keys, valid, h, max_probes=max_probes
    )
    return tkeys, counts, jnp.sum(pending.astype(jnp.int32)), pending


class BloomFilteredCounter(KmerCounter):
    """Pass-2 counter: windows must hit BF2 to be counted."""

    def __init__(self, config: CounterConfig, bf2, hfn: int):
        super().__init__(config)
        self.bf2 = bf2
        self.hfn = hfn

    def _count_step(self, tiles):
        return _bloom_count_step(
            self.tkeys, self.counts, self.bf2, tiles,
            self.cfg.k, self.hfn, self.cfg.max_probes,
        )


def bloom_pass1(cfg: BloomCounterConfig, chunks):
    """Stream chunks through the Bloom filter; returns (bf2, hfn, stats)."""
    bits, hfn = bloom_sizing(cfg.expected_unique, cfg.fpr)
    bits = max(bits, 1 << 10)
    # blocked layout: extra bits buy back the one-word fp inflation
    bits *= bloom_ops.BLOCK_COMPENSATION
    bf1 = bloom_ops.make_bloom(bits)
    bf2 = bloom_ops.make_bloom(bits)
    new1 = 0
    new2 = 0
    t0 = time.perf_counter()
    batcher = TileBatcher(cfg.k, cfg.tile, cfg.batch_tiles)

    def run(tiles):
        nonlocal bf1, bf2, new1, new2
        bf1, bf2, n1, n2 = _bloom_pass1_step(bf1, bf2, jnp.asarray(tiles), cfg.k, hfn)
        new1 += int(n1)
        new2 += int(n2)

    for codes in chunks:
        for tiles in batcher.add(codes):
            run(tiles)
    for tiles in batcher.finish():
        run(tiles)

    stats = {
        "bloom_bits": bits,
        "bloom_hash_functions": hfn,
        "new_in_first": new1,
        "new_in_second": new2,
        "bloom_pass_seconds": time.perf_counter() - t0,
    }
    # squeeze: BF1 is no longer needed once sizing is known.
    del bf1
    return bf2, hfn, stats


def bloom_count_file(cfg: BloomCounterConfig, path: str,
                     chunk_bytes: int = io_reader.DEFAULT_CHUNK_BYTES,
                     prefetch: int = 4) -> BloomFilteredCounter:
    def stream():
        chunks = io_reader.CodeChunkReader(path, chunk_bytes=chunk_bytes)
        if prefetch:
            chunks = io_reader.PrefetchingReader(chunks, depth=prefetch)
        return chunks

    bf2, hfn, stats = bloom_pass1(cfg, stream())
    min_slots = max(1 << 10, 2 * stats["new_in_second"])
    ccfg = CounterConfig(
        k=cfg.k, min_slots=min_slots, mode=cfg.mode,
        min_abundance=cfg.min_abundance, tile=cfg.tile,
        batch_tiles=cfg.batch_tiles, max_probes=cfg.max_probes,
    )
    counter = BloomFilteredCounter(ccfg, bf2, hfn)
    counter.stats.update(stats)
    for codes in stream():
        counter.add_codes(codes)
    counter.finish()
    return counter


def bloom_count_codes(cfg: BloomCounterConfig, codes: np.ndarray) -> BloomFilteredCounter:
    """In-memory two-pass variant (tests, library use)."""
    bf2, hfn, stats = bloom_pass1(cfg, [np.asarray(codes, np.uint8)])
    min_slots = max(1 << 10, 2 * stats["new_in_second"])
    ccfg = CounterConfig(
        k=cfg.k, min_slots=min_slots, mode=cfg.mode,
        min_abundance=cfg.min_abundance, tile=cfg.tile,
        batch_tiles=cfg.batch_tiles, max_probes=cfg.max_probes,
    )
    counter = BloomFilteredCounter(ccfg, bf2, hfn)
    counter.stats.update(stats)
    counter.count_codes(codes)
    return counter


# ---------------------------------------------------------------------------
# Two-pass Bloom prefilter on the SORT backend (the flagship path)
# ---------------------------------------------------------------------------
# Same two-pass mechanism as above (reference: main.cpp:395-510) riding
# the sort backend's streaming machinery: pass 1 reuses the host
# pack/transfer pipeline with a BF-insertion superstep; pass 2 is the
# ordinary counting pipeline with failing windows turned into sentinel
# rows BEFORE the sort (ops/sortcount.py), so singletons never enter
# the merge — the sorted-store analogue of the reference's table-size
# reduction, and a merge-mass cut on high-duplication inputs.

from ..ops import sortcount as _sortcount
from .sort_counter import SortCounterConfig, SortKmerCounter
from .skm_counter import SkmCounter


class BloomSortCounter(SortKmerCounter):
    """Sort-backend counter with the two-stage Bloom prefilter.

    Drive with :func:`bloom_sort_count_file` / ``_codes`` (two passes
    over the input), or manually: stream pass-1 input via
    add_codes/finish, call ``start_pass2()``, then stream again.
    """

    def __init__(self, config: SortCounterConfig, expected_unique: int,
                 fpr: float = 0.01):
        super().__init__(config)
        bits, hfn = bloom_sizing(expected_unique, fpr)
        bits = max(bits, 1 << 10)
        # blocked layout: extra bits buy back the one-word fp inflation
        bits *= bloom_ops.BLOCK_COMPENSATION
        self.hfn = hfn
        self.bf1 = bloom_ops.make_bloom(bits)
        self.bf2 = bloom_ops.make_bloom(bits)
        self._phase = 1
        self._n12 = []
        self.stats.update({"bloom_bits": bits, "bloom_hash_functions": hfn,
                           "new_in_first": 0, "new_in_second": 0})

    def _superstep_kwargs(self) -> dict:
        return {"bloom": self.bf2, "hfn": self.hfn} if self._phase == 2 else {}

    def _dispatch(self, packed_d, sep_d, n: int, dense: bool,
                  wstart: int = 0, srow: int = 0):
        if self._phase != 1:
            return super()._dispatch(packed_d, sep_d, n, dense, wstart, srow)
        cfg = self.cfg
        self.bf1, self.bf2, n1, n2 = _sortcount.bloom_pass1_superstep(
            self.bf1, self.bf2, packed_d, sep_d, wstart, srow,
            k=cfg.k, n=n, rows=min(cfg.rows, n), dense=dense,
            hfn=self.hfn, winkeys=cfg.winkeys)
        self._n12.append((n1, n2))

    def start_pass2(self):
        """Finish pass 1: size the distinct store from the BF2
        cardinality counter (reference: main.cpp:454) and squeeze
        (drop BF1 — reference: include/mybitarray.hpp:127-162)."""
        if self._phase != 1:
            raise RuntimeError("start_pass2 called twice")
        self.finish()
        new1 = sum(int(a) for a, _ in self._n12)
        new2 = sum(int(b) for _, b in self._n12)
        self._n12 = []
        self.stats["new_in_first"] = new1
        self.stats["new_in_second"] = new2
        pass1_batches = self.stats["batches"]
        self.stats["batches"] = 0
        self.stats["pass1_batches"] = pass1_batches
        self.stats["windows_processed"] = 0
        min_slots = max(1 << 10, 2 * new2)
        need = 1 << (min_slots - 1).bit_length()
        if need > self.cfg.prefix_cap:
            self.cfg.prefix_cap = need
            self.prefix = _sortcount.make_store(need, self.cfg.words)
        self.bf1 = None  # squeeze
        self._phase = 2


def bloom_sort_count_file(cfg: SortCounterConfig, expected_unique: int,
                          fpr: float, path: str,
                          chunk_bytes: int = io_reader.DEFAULT_CHUNK_BYTES,
                          prefetch: int = 4) -> BloomSortCounter:
    counter = BloomSortCounter(cfg, expected_unique, fpr)
    for pass_no in (1, 2):
        chunks = io_reader.CodeChunkReader(path, chunk_bytes=chunk_bytes)
        if prefetch:
            chunks = io_reader.PrefetchingReader(chunks, depth=prefetch)
        for codes in chunks:
            counter.add_codes(codes)
        if pass_no == 1:
            counter.start_pass2()
        else:
            counter.finish()
    return counter


def bloom_sort_count_codes(cfg: SortCounterConfig, expected_unique: int,
                           fpr: float, codes: np.ndarray) -> BloomSortCounter:
    """In-memory two-pass variant (tests, library use)."""
    counter = BloomSortCounter(cfg, expected_unique, fpr)
    counter.add_codes(np.asarray(codes, np.uint8))
    counter.start_pass2()
    counter.count_codes(codes)
    return counter


class BloomSkmCounter(SkmCounter):
    """Super-k-mer pipeline with the two-stage Bloom prefilter
    (``--pipeline skm -b``).

    Pass 1 is the same window-hash BF fill as BloomSortCounter (it
    needs only window keys, so it is pipeline-agnostic).  Pass 2
    streams runs UNFILTERED — a run row packs up to LMAX windows, so a
    per-window filter cannot apply during streaming — and the BF2 gate
    is applied where windows materialize: at finalize expansion
    (ops/skm.py expand_chunk), exactly mirroring the reference's pass-2
    admission test (reference: include/parallel_parser.hpp:2436-2454).
    The memory the mode buys is the same as in the reference: the
    FINAL k-mer store holds only BF2 hits (singletons never enter it);
    the run store is the compressed stream representation either way.
    """

    def __init__(self, config, expected_unique: int, fpr: float = 0.01):
        super().__init__(config)
        bits, hfn = bloom_sizing(expected_unique, fpr)
        bits = max(bits, 1 << 10)
        bits *= bloom_ops.BLOCK_COMPENSATION
        self.hfn = hfn
        self.bf1 = bloom_ops.make_bloom(bits)
        self.bf2 = bloom_ops.make_bloom(bits)
        self._phase = 1
        self._n12 = []
        self.stats.update({"bloom_bits": bits, "bloom_hash_functions": hfn,
                           "new_in_first": 0, "new_in_second": 0})

    def _dispatch(self, packed_d, sep_d, n: int, dense: bool,
                  wstart: int = 0, srow: int = 0):
        if self._phase != 1:
            return super()._dispatch(packed_d, sep_d, n, dense, wstart, srow)
        cfg = self.cfg
        self.bf1, self.bf2, n1, n2 = _sortcount.bloom_pass1_superstep(
            self.bf1, self.bf2, packed_d, sep_d, wstart, srow,
            k=cfg.k, n=n, rows=min(cfg.rows, n), dense=dense,
            hfn=self.hfn, winkeys=cfg.winkeys)
        self._n12.append((n1, n2))

    def start_pass2(self):
        """Finish pass 1, record the exactly-once counters, squeeze BF1
        (reference: include/mybitarray.hpp:127-162).  The run store
        needs no BF-derived sizing (it grows by replay); new_in_second
        bounds the FINALIZED store instead."""
        if self._phase != 1:
            raise RuntimeError("start_pass2 called twice")
        self.finish()
        self.stats["new_in_first"] = sum(int(a) for a, _ in self._n12)
        self.stats["new_in_second"] = sum(int(b) for _, b in self._n12)
        self._n12 = []
        self.stats["pass1_batches"] = self.stats["batches"]
        self.stats["batches"] = 0
        self.stats["windows_processed"] = 0
        self.bf1 = None  # squeeze
        self._phase = 2

    def finalize_device(self):
        """Device finalize with the BF2 gate at expansion."""
        self._flush()
        self._merge()
        tag = (self.stats["windows_processed"], self.n_used)
        if self._final_cache is not None and self._final_cache[0] == tag:
            return self._final_cache[1]
        m = self.prefix[0].shape[0]
        need = max(self.n_used, 1)
        if need < m:
            lo = 1 << max((need - 1).bit_length() - 3, 3)
            m = min(m, -(-need // lo) * lo)
        run_cols = tuple(c[:m] for c in self.prefix)
        from ..ops import skm as skm_ops

        out = skm_ops.finalize_store(run_cols, self.cfg.k,
                                     bloom=self.bf2, hfn=self.hfn)
        self._final_cache = (tag, out)
        return out


def bloom_skm_count_codes(cfg, expected_unique: int, fpr: float,
                          codes: np.ndarray) -> BloomSkmCounter:
    """In-memory two-pass skm variant (tests, library use)."""
    counter = BloomSkmCounter(cfg, expected_unique, fpr)
    counter.add_codes(np.asarray(codes, np.uint8))
    counter.start_pass2()
    counter.count_codes(codes)
    return counter


def bloom_skm_count_file(cfg, expected_unique: int, fpr: float, path: str,
                         chunk_bytes: int = io_reader.DEFAULT_CHUNK_BYTES,
                         prefetch: int = 4) -> BloomSkmCounter:
    counter = BloomSkmCounter(cfg, expected_unique, fpr)
    for pass_no in (1, 2):
        chunks = io_reader.CodeChunkReader(path, chunk_bytes=chunk_bytes)
        if prefetch:
            chunks = io_reader.PrefetchingReader(chunks, depth=prefetch)
        for codes in chunks:
            counter.add_codes(codes)
        if pass_no == 1:
            counter.start_pass2()
        else:
            counter.finish()
    return counter
