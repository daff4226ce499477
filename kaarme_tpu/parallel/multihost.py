"""Multi-host (multi-process) distributed counting.

The reference is strictly single-node (SURVEY.md section 0: C++17 +
pthreads on one machine); this module provides the scale-out the driver
targets (BASELINE.md: chr20-scale input sharded across N >= 2 hosts,
>= 80% scaling efficiency):

- ``jax.distributed.initialize`` builds one global runtime; the mesh
  spans every device of every host and collectives ride the device
  interconnect (CPU testing uses gloo).
- **input sharding is byte-span based**: host h owns the windows whose
  first base lies in file bytes [h*size/H, (h+1)*size/H), reads ONLY
  that span plus a forward halo of k-1 codes (the cross-host version of
  the reference's k-1 chunk back-seek, include/text_reader.h:206-213),
  and never communicates during streaming.
- hosts agree on the number of global supersteps with a one-scalar
  ``psum`` per round (a host whose span is exhausted feeds an all-
  separator batch, which contributes zero windows), so the SPMD
  programs stay in lockstep without a shared queue.
- the only data exchange is the finalize ``all_to_all`` of distinct
  records inherited from ShardedSortCounter.

Launcher: every host runs

    python -m kaarme_tpu.parallel.multihost INPUT KLEN \
        --coordinator HOST0:PORT --num-processes H --process-id h \
        -s SLOTS -o OUT

and writes its hash-partition to ``OUT.part{h}`` (merge with
``--merge-parts`` on a shared filesystem, or post-process the parts —
they are disjoint by construction).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..io import reader as io_reader
from ..io import fastio
from ..utils import codec

DEFAULT_CHUNK_BYTES = io_reader.DEFAULT_CHUNK_BYTES


# ---------------------------------------------------------------------------
# Runtime init
# ---------------------------------------------------------------------------

def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None):
    """Initialize the global JAX runtime across hosts.

    Arguments default to the KAARME_COORDINATOR / KAARME_NUM_PROCS /
    KAARME_PROC_ID environment variables; in a cluster environment
    JAX can detect, all three may be None (auto-detection).  CPU processes
    use the gloo collectives backend (how the tests validate multi-host
    without multi-host hardware).
    """
    import jax

    coordinator = coordinator or os.environ.get("KAARME_COORDINATOR")
    if num_processes is None and "KAARME_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["KAARME_NUM_PROCS"])
    if process_id is None and "KAARME_PROC_ID" in os.environ:
        process_id = int(os.environ["KAARME_PROC_ID"])
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(platform: str | None = None):
    """1-D mesh over every device of every participating process."""
    import jax
    from jax.sharding import Mesh

    devs = jax.devices(platform) if platform else jax.devices()
    return Mesh(np.asarray(devs), ("d",))


# ---------------------------------------------------------------------------
# Per-host input spans
# ---------------------------------------------------------------------------

def _find_line_start(f, pos: int, block: int = 1 << 16) -> int:
    """Byte offset of the first character of the line containing pos."""
    while pos > 0:
        lo = max(0, pos - block)
        f.seek(lo)
        buf = f.read(pos - lo)
        j = buf.rfind(b"\n")
        if j >= 0:
            return lo + j + 1
        pos = lo
    return 0


def _find_fastq_record_start(f, pos: int, size: int,
                             block: int = 1 << 20) -> int:
    """Byte offset of the first FASTQ record start at or after pos.

    A line is a record start iff it begins with '@' and the line two
    below begins with '+' (4-line FASTQ).  The '@' byte also occurs in
    quality strings, but a quality line q has q+1 = header and
    q+2 = sequence, and sequences never begin with '+', so the test
    cannot fire on a quality line.
    """
    if pos == 0:
        return 0
    start = _find_line_start(f, pos)
    f.seek(start)
    buf = b""
    base = start
    while True:
        more = f.read(block)
        if more:
            buf += more
        # line offsets within buf (buf always starts at a line start)
        offs = [0]
        j = buf.find(b"\n")
        while j >= 0:
            offs.append(j + 1)
            j = buf.find(b"\n", j + 1)
        # need candidate line i plus line i+2 to be COMPLETE in buf
        for i in range(len(offs) - 3):
            if buf[offs[i]: offs[i] + 1] == b"@" and \
                    buf[offs[i + 2]: offs[i + 2] + 1] == b"+":
                return base + offs[i]
        if not more:
            return size
        # drop fully-scanned lines, keep the last 3 partial candidates
        if len(offs) > 3:
            cut = offs[-3]
            base += cut
            buf = buf[cut:]


class HostSpanReader:
    """Encoded code chunks for ONE host's byte span of a shared input.

    Ownership contract: the union over hosts of the windows produced
    from each host's (span + forward halo) equals the single-host
    window multiset, each window exactly once.

    - span: bytes [h*size/H, (h+1)*size/H); encoding starts there, so
      the first code is the first base at or after the span start (a
      FASTA span starting inside a header line resumes in skip-header
      state, determined by one backward line scan);
    - forward halo: after the span, encoding continues until k-1 codes
      were collected OR a separator code appears (a separator kills
      every window that reaches it, so nothing after it can matter) —
      windows never *start* in the halo because a length-L code stream
      produces L-k+1 windows;
    - formats: fasta + plain.  Multi-host gzip is rejected (no random
      access; decompress or split first), FASTQ is rejected (restart
      markers are ambiguous mid-file).
    """

    def __init__(self, path: str, host_id: int, num_hosts: int, k: int,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 fmt: str | None = None, gzipped: bool | None = None):
        if not (0 <= host_id < num_hosts):
            raise ValueError("host_id out of range")
        if fmt is None or gzipped is None:
            fmt, gzipped = io_reader.sniff_format(path)
        if gzipped:
            raise ValueError(
                "multi-host gzip input is not supported (gzip has no random "
                "access): run kaarme_tpu.parallel.multihost --presplit to "
                "produce per-host record-aligned parts, or decompress first")
        self.path, self.fmt, self.k = path, fmt, k
        self.chunk_bytes = int(chunk_bytes)
        size = os.path.getsize(path)
        self.begin = host_id * size // num_hosts
        self.end = (host_id + 1) * size // num_hosts
        self.size = size
        if fmt == "fastq":
            # record-aligned ownership: host h owns the records STARTING
            # in its byte span; records are window-isolated (the encoder
            # separates them), so no cross-host halo is needed
            with open(path, "rb") as f:
                self.begin = _find_fastq_record_start(f, self.begin, size)
                self.end = _find_fastq_record_start(f, self.end, size) \
                    if self.end < size else size

    def _encode(self, buf: bytes, in_header: bool):
        if self.fmt == "fasta":
            return fastio.encode_fasta(buf, in_header)
        return fastio.encode_plain(buf), False

    def __iter__(self):
        if self.fmt == "fastq":
            yield from self._iter_fastq()
            return
        with open(self.path, "rb") as f:
            in_header = False
            if self.fmt == "fasta" and self.begin > 0:
                ls = _find_line_start(f, self.begin)
                f.seek(ls)
                if f.read(1) == b">":
                    # the span starts inside a header line: stay in
                    # skip-until-newline state (the '>' owner emits the
                    # separator for this record boundary)
                    in_header = True
            f.seek(self.begin)
            remaining = self.end - self.begin
            while remaining > 0:
                buf = f.read(min(self.chunk_bytes, remaining))
                if not buf:
                    break
                remaining -= len(buf)
                codes, in_header = self._encode(buf, in_header)
                if codes.shape[0]:
                    yield codes
            # forward halo: k-1 codes, or up to the first separator
            if self.end >= self.size:
                return
            need = self.k - 1
            halo = []
            while need > 0:
                buf = f.read(min(self.chunk_bytes, 1 << 20))
                if not buf:
                    break
                codes, in_header = self._encode(buf, in_header)
                if not codes.shape[0]:
                    continue
                seps = np.flatnonzero(codes[:need] >= codec.SEP)
                if seps.size:
                    # a separator within the halo kills every window
                    # that reaches it — include it, then stop
                    halo.append(codes[: seps[0] + 1])
                    break
                take = codes[:need]
                halo.append(take)
                need -= take.shape[0]
            if halo:
                yield np.concatenate(halo)

    def _iter_fastq(self):
        """Record-aligned FASTQ span: encode [begin, end) with the
        stateful FASTQ machine; the span is record-complete by
        construction (ends exactly at the next host's first record)."""
        from ..utils import codec as _codec

        state = _codec.FASTQ_STATE0
        with open(self.path, "rb") as f:
            f.seek(self.begin)
            remaining = self.end - self.begin
            while remaining > 0:
                buf = f.read(min(self.chunk_bytes, remaining))
                if not buf:
                    break
                remaining -= len(buf)
                codes, state = fastio.encode_fastq(buf, state)
                if codes.shape[0]:
                    yield codes


def presplit(path: str, num_hosts: int, out_prefix: str,
             block_records: int = 4096) -> list:
    """Pre-split a (possibly gzipped) FASTA/FASTQ/plain input into
    ``num_hosts`` record-aligned part files for multi-host runs where
    byte-span ownership cannot work (gzip has no random access).

    Single streaming pass: records are dealt to parts in round-robin
    blocks of ``block_records``, which balances part sizes without
    knowing the uncompressed size up front.  Records are independent
    for counting (every record boundary is a window separator), so the
    reordering cannot change any count.  Returns the part paths.
    """
    import gzip

    fmt, gzipped = io_reader.sniff_format(path)
    opener = gzip.open if gzipped else open
    paths = [f"{out_prefix}.host{h}" for h in range(num_hosts)]
    outs = [open(p, "wb") for p in paths]
    try:
        with opener(path, "rb") as f:
            h = 0
            nrec = 0
            if fmt == "fastq":
                while True:
                    rec = [f.readline() for _ in range(4)]
                    if not rec[0]:
                        break
                    if not all(rec) or not rec[2].startswith(b"+"):
                        # truncated/malformed tail record: writing a
                        # partial 4-line record would corrupt the part
                        import warnings

                        warnings.warn(
                            f"presplit: dropping truncated FASTQ tail "
                            f"record in {path!r}")
                        break
                    outs[h].writelines(rec)
                    nrec += 1
                    if nrec % block_records == 0:
                        h = (h + 1) % num_hosts
            elif fmt == "fasta":
                cur = None
                for line in f:
                    if line.startswith(b">"):
                        # same post-increment rotation as the FASTQ/plain
                        # branches (rotate when a block completes), so
                        # block_records=1 deals one record per host
                        if nrec and nrec % block_records == 0:
                            h = (h + 1) % num_hosts
                        nrec += 1
                        cur = h
                    if cur is not None:
                        outs[cur].write(line)
            else:
                for line in f:
                    outs[h].write(line)
                    nrec += 1
                    if nrec % block_records == 0:
                        h = (h + 1) % num_hosts
    finally:
        for o in outs:
            o.close()
    return paths


def host_span_codes(path: str, host_id: int, num_hosts: int, k: int, **kw):
    """Whole-span convenience: this host's full encoded stream."""
    chunks = list(HostSpanReader(path, host_id, num_hosts, k, **kw))
    if not chunks:
        return np.empty(0, np.uint8)
    return np.concatenate(chunks)


# ---------------------------------------------------------------------------
# Multi-host counter
# ---------------------------------------------------------------------------

def _make_multihost_cls():
    """Deferred so importing this module never forces a jax import."""
    import jax
    from jax.sharding import PartitionSpec as P

    from .sharded_sort import ShardedSortCounter

    class MultiHostSortCounter(ShardedSortCounter):
        """ShardedSortCounter over a global multi-process mesh.

        Streaming is host-local (each host's devices consume the host's
        byte span); the per-round lockstep flag and the finalize
        exchange are the only collectives.  Every jitted
        step/merge/exchange program is the identical SPMD program on
        every host.
        """

        def __init__(self, config, mesh=None):
            if mesh is None:
                mesh = global_mesh()
            devs = list(mesh.devices.flat)
            platform = devs[0].platform
            self.pid = jax.process_index(backend=platform)
            self.nproc = jax.process_count(backend=platform)
            self.local_devs = [d for d in devs if d.process_index == self.pid]
            self.nloc = len(self.local_devs)
            super().__init__(config, mesh)
            self._flag = jax.jit(jax.shard_map(
                lambda x: jax.lax.psum(x, "d")[None],
                mesh=mesh, in_specs=P("d"), out_specs=P("d")))

        # -- placement overrides (local shards only) ---------------------

        def _put_local(self, local_rows: np.ndarray):
            """(nloc, ...) host rows for this process's mesh devices ->
            global (ndev, ...) array."""
            a = np.asarray(local_rows)
            gshape = (self.ndev,) + a.shape[1:]
            shards = [jax.device_put(a[j:j + 1], d)
                      for j, d in enumerate(self.local_devs)]
            return jax.make_array_from_single_device_arrays(
                gshape, self._sharding2, shards)

        def _put_const(self, fill, dtype, cap: int):
            return self._put_local(np.full((self.nloc, cap), fill, dtype))

        def _put_rows(self, rows_np: np.ndarray):
            # base-class _flush is not used multi-host; guard anyway
            if rows_np.shape[0] == self.nloc:
                return self._put_local(rows_np)
            raise RuntimeError("use count_file/count_codes on the "
                               "multi-host counter")

        # -- counting -----------------------------------------------------

        def count_file(self, path: str,
                       chunk_bytes: int = DEFAULT_CHUNK_BYTES, **kw):
            reader = HostSpanReader(path, self.pid, self.nproc, self.cfg.k,
                                    chunk_bytes=chunk_bytes)
            return self.count_codes_stream(iter(reader))

        def count_codes(self, codes: np.ndarray):
            """Count THIS host's span codes (lockstep rounds with peers)."""
            return self.count_codes_stream(
                iter([np.asarray(codes, np.uint8)]))

        def count_codes_stream(self, chunks):
            cfg = self.cfg
            k = cfg.k
            sb = self.nloc * cfg.batch_windows  # host windows per round
            pending: list = []
            pending_n = 0
            exhausted = False
            while True:
                while not exhausted and pending_n < sb + k - 1:
                    try:
                        c = next(chunks)
                    except StopIteration:
                        exhausted = True
                        break
                    pending.append(np.asarray(c, np.uint8))
                    pending_n += pending[-1].shape[0]
                have = 1 if pending_n >= k else 0
                flags = self._flag(self._put_local(
                    np.full((self.nloc,), have, np.int32)))
                if self._scalar(flags.addressable_shards[0].data[:1]) == 0:
                    break
                stream = np.concatenate(pending) if pending else \
                    np.empty(0, np.uint8)
                n_real = max(stream.shape[0] - k + 1, 0) if have else 0
                span = np.full(sb + k - 1, codec.SEP, np.uint8)
                m = min(stream.shape[0], span.shape[0])
                span[:m] = stream[:m]
                leftover = stream[sb:] if stream.shape[0] > sb else \
                    np.empty(0, np.uint8)
                pending = [leftover] if leftover.shape[0] else []
                pending_n = int(leftover.shape[0])
                self._host_flush(span, min(n_real, sb))
            self._merge()
            return self

        def finish(self):
            raise RuntimeError("multi-host counting is round-driven: use "
                               "count_file / count_codes")

        def _host_flush(self, stream: np.ndarray, n_real: int):
            """Local-span _flush: pack rows for this host's devices only.
            The separator representation is forced DENSE so every
            process runs the identical superstep program without
            communicating the separator census (lockstep SPMD)."""
            if self._exchanged:
                raise RuntimeError("cannot add input after finalize")
            packed, sep, dense = self._pack_rows(stream, self.nloc,
                                                 force_dense=True)
            self._run_superstep(self._put_local(packed),
                                self._put_local(sep), dense)
            self.stats["batches"] += 1
            self.stats["windows_processed"] += max(n_real, 0)

        # -- output -------------------------------------------------------

        def dump(self):
            return self.dump_local()

        def dump_local(self):
            """This host's hash-partition of the distinct set: (keys
            (N, W) uint32 sorted, counts (N,) int64).  Partitions are
            disjoint across hosts (owner = top hash bits)."""
            self.finalize_exchange()
            w = self.cfg.words
            cols = []
            for c in self.prefix:
                shards = sorted(c.addressable_shards,
                                key=lambda s: s.index[0].start or 0)
                cols.append(np.concatenate(
                    [np.asarray(jax.device_get(s.data)).reshape(-1)
                     for s in shards]))
            cnt = cols[-1].astype(np.int64)
            alive = cnt > 0
            keys = np.stack([c[alive] for c in cols[:w]], axis=1)
            cnt = cnt[alive]
            order = np.lexsort(
                tuple(keys[:, i] for i in range(w - 1, -1, -1)))
            return keys[order], cnt[order]

        def write_output_part(self, path: str) -> int:
            """Write this host's partition to ``path.part{pid}``."""
            out = f"{path}.part{self.pid}"
            return self.write_output(out)   # write_output rides dump()

        def occupancy(self):
            self._merge()
            cnt = np.concatenate(
                [np.asarray(jax.device_get(s.data)).reshape(-1)
                 for s in self.prefix[-1].addressable_shards])
            return int((cnt > 0).sum()), int(cnt.size)

        def as_dict_local(self) -> dict:
            """This host's hash-partition as {kmer: count} (partitions
            are disjoint; the union over hosts is the global answer)."""
            return super().as_dict()

        # Inherited global-answer APIs would silently return this
        # host's partition (find/as_dict) or device_get non-addressable
        # shards (save) — block them with actionable errors instead.

        def find(self, kmers):
            raise NotImplementedError(
                "find() on a multi-host counter sees only this host's "
                "hash-partition; query the merged output file, or run "
                "find on each host and take the nonzero answer")

        def as_dict(self) -> dict:
            raise NotImplementedError(
                "as_dict() would return only this host's partition; "
                "use as_dict_local() (disjoint across hosts) or "
                "write_output_part() + merge_parts()")

        def save(self, path: str):
            """Per-process checkpoint part: snapshot THIS process's
            addressable shards (pre-exchange partial counts, same
            semantics as ShardedSortCounter.save — the same key may
            hold partial counts on several shards/parts; the first
            compaction after restore sums them) to ``path.part{pid}``.

            COLLECTIVE DISCIPLINE: every process must call save at the
            same round boundary (between count_codes/count_file calls,
            before finalize).  Restore with ``load`` on any process
            count — parts are dealt round-robin (requires the parts on
            a filesystem every restoring process can read, like
            merge_parts)."""
            if self._exchanged:
                raise RuntimeError("cannot checkpoint after finalize")
            self._merge()
            w = self.cfg.words
            cols = []
            for c in self.prefix:
                shards = sorted(c.addressable_shards,
                                key=lambda s: s.index[0].start or 0)
                cols.append(np.concatenate(
                    [np.asarray(jax.device_get(s.data)).reshape(-1)
                     for s in shards]))
            cnt = cols[-1]
            alive = cnt > 0
            keys = np.stack([c[alive] for c in cols[:w]], axis=1)
            # atomic part write: a crash mid-write must not leave a
            # truncated file at the canonical name
            tmp = f"{path}.part{self.pid}.tmp.npz"
            np.savez_compressed(
                tmp, kind="multihost_sort",
                k=self.cfg.k, mode=self.cfg.mode,
                min_abundance=self.cfg.min_abundance,
                keys=keys, counts=cnt[alive].astype(np.int64),
                windows_processed=self.stats["windows_processed"],
                num_parts=self.nproc)
            os.replace(tmp, f"{path}.part{self.pid}.npz")

        @classmethod
        def load(cls, path: str, config=None, mesh=None):
            """Restore from per-process ``save`` parts onto the current
            global mesh (any process count).  Every process must call
            load; parts are assigned round-robin by process id, and the
            per-device capacity is derived DETERMINISTICALLY from all
            part sizes so every process builds identically-shaped
            global arrays without a collective."""
            from ..ops.sortcount import next_store_size
            from .sharded_sort import ShardedSortConfig

            z0 = np.load(f"{path}.part0.npz")
            if "kind" not in z0.files or str(z0["kind"]) != "multihost_sort":
                raise ValueError(f"{path}.part0.npz is not a multi-host "
                                 "checkpoint")
            num_parts = int(z0["num_parts"])
            k = int(z0["k"])
            if config is None:
                config = ShardedSortConfig(
                    k=k, mode=int(z0["mode"]),
                    min_abundance=int(z0["min_abundance"]))
            elif config.k != k:
                raise ValueError(
                    f"checkpoint is for k={k}, config has k={config.k}")
            self = cls(config, mesh)
            w = config.words
            # row counts of every part (cheap: one array header decode
            # each) -> the max per-process aggregate row need, computed
            # identically on every process
            rows_of = [int(np.load(f"{path}.part{h}.npz")["counts"].shape[0])
                       for h in range(num_parts)]
            need = max(sum(rows_of[p::self.nproc])
                       for p in range(self.nproc)) or 1
            per = -(-need // self.nloc)
            while per > self.cfg.prefix_cap:
                self.cfg.prefix_cap = next_store_size(self.cfg.prefix_cap + 1)
            cap = self.cfg.prefix_cap

            keys_l, cnt_l, wins = [], [], 0
            for h in range(self.pid, num_parts, self.nproc):
                z = np.load(f"{path}.part{h}.npz")
                keys_l.append(z["keys"].astype(np.uint32))
                cnt_l.append(z["counts"].astype(np.int64))
                wins += int(z["windows_processed"])
            keys = np.concatenate(keys_l) if keys_l else \
                np.zeros((0, w), np.uint32)
            cnt = np.concatenate(cnt_l) if cnt_l else np.zeros(0, np.int64)
            # aggregate duplicates + sort (each shard prefix must be a
            # sorted run with one record per key — see sharded load)
            if keys.shape[0]:
                order = np.lexsort(
                    tuple(keys[:, i] for i in range(w - 1, -1, -1)))
                keys, cnt = keys[order], cnt[order]
                first = np.ones(keys.shape[0], bool)
                first[1:] = (keys[1:] != keys[:-1]).any(axis=1)
                starts = np.flatnonzero(first)
                cnt = np.add.reduceat(cnt, starts)
                keys = keys[starts]
            n = keys.shape[0]
            per = -(-max(n, 1) // self.nloc)
            big = 1 << 20
            cc = np.where(cnt > big, big + (cnt & (big - 1)),
                          cnt).astype(np.int32)
            cols = []
            for j in range(w):
                col = np.full((self.nloc, cap), 0xFFFFFFFF, np.uint32)
                for d in range(self.nloc):
                    part = keys[d * per: (d + 1) * per, j]
                    col[d, : part.shape[0]] = part
                cols.append(self._put_local(col))
            ccol = np.zeros((self.nloc, cap), np.int32)
            for d in range(self.nloc):
                part = cc[d * per: (d + 1) * per]
                ccol[d, : part.shape[0]] = part
            cols.append(self._put_local(ccol))
            self.prefix = tuple(cols)
            self.stats["windows_processed"] = wins
            return self

    return MultiHostSortCounter


_MultiHostSortCounter = None


def MultiHostSortCounter(config, mesh=None):
    """Factory for the multi-host counter class (lazy jax import)."""
    global _MultiHostSortCounter
    if _MultiHostSortCounter is None:
        _MultiHostSortCounter = _make_multihost_cls()
    return _MultiHostSortCounter(config, mesh)


def multihost_load(path: str, config=None, mesh=None):
    """Restore a multi-host counter from per-process ``save`` parts
    (collective: every process calls this; see the class docstring)."""
    global _MultiHostSortCounter
    if _MultiHostSortCounter is None:
        _MultiHostSortCounter = _make_multihost_cls()
    return _MultiHostSortCounter.load(path, config, mesh)


def merge_parts(out_path: str, num_parts: int,
                buf_bytes: int = 1 << 22) -> int:
    """STREAMING merge of per-host part files into one output file.

    Each part is written in sorted key order (dump_local sorts, and
    big-endian 2-bit packing makes key order == ACGT string order) and
    partitions are disjoint, so a heap k-way merge holds only one
    buffered line per part — chr20-scale parts never land in RAM at
    once (the old implementation loaded and sorted all lines)."""
    import heapq
    from contextlib import ExitStack

    n = 0
    with ExitStack() as stack:
        files = [stack.enter_context(
            open(f"{out_path}.part{h}", "rb", buffering=buf_bytes))
            for h in range(num_parts)]
        out = stack.enter_context(open(out_path, "wb", buffering=buf_bytes))
        for line in heapq.merge(*files):
            out.write(line)
            n += 1
    return n


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="kaarme_tpu.multihost",
        description="Multi-host canonical k-mer counting (one process per host)")
    ap.add_argument("INPUT")
    ap.add_argument("KLEN", type=int)
    ap.add_argument("--coordinator", default=None,
                    help="host0 address:port (or KAARME_COORDINATOR)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--platform", default=None,
                    help="device platform for the mesh (default: runtime default)")
    ap.add_argument("-s", "--hash-tab-size", type=int, default=0)
    ap.add_argument("-m", "--hash-table-type", type=int, default=2)
    ap.add_argument("-a", "--min-k-abu", type=int, default=2)
    ap.add_argument("-o", "--output-file", required=True)
    ap.add_argument("--batch-log2", type=int, default=20)
    ap.add_argument("--merge-parts", action="store_true",
                    help="after counting, process 0 merges all part files "
                         "(requires a shared filesystem)")
    ap.add_argument("--presplit", type=int, default=0, metavar="H",
                    help="do not count: split INPUT (gzip ok) into H "
                         "record-aligned part files next to -o and exit")
    args = ap.parse_args(argv)

    if args.presplit:
        paths = presplit(args.INPUT, args.presplit, args.output_file)
        print("\n".join(paths))
        return 0

    if args.platform == "cpu":
        # pin BEFORE backend init so a CPU worker never initializes an
        # accelerator backend
        import jax

        jax.config.update("jax_platforms", "cpu")
    init_distributed(args.coordinator, args.num_processes, args.process_id)

    from ..ops.sortcount import next_store_size
    from .sharded_sort import ShardedSortConfig

    mesh = global_mesh(args.platform)
    # -s sizes the distinct store like the reference's table size
    # (reference main.cpp: table slots >= -s): split across the global
    # mesh since prefix_cap is PER-DEVICE; growth covers underestimates.
    cap = 1 << max(10, args.batch_log2 - 2)
    if args.hash_tab_size:
        ndev = int(mesh.devices.size)
        cap = max(cap, next_store_size(-(-args.hash_tab_size // ndev)))
    cfg = ShardedSortConfig(
        k=args.KLEN, mode=args.hash_table_type, min_abundance=args.min_k_abu,
        batch_windows=1 << args.batch_log2,
        rows=1 << (args.batch_log2 // 2),
        prefix_cap=cap,
    )
    c = MultiHostSortCounter(cfg, mesh)
    c.count_file(args.INPUT)
    n = c.write_output_part(args.output_file)
    print(f"host {c.pid}/{c.nproc}: {n} k-mers -> "
          f"{args.output_file}.part{c.pid}", flush=True)
    if args.merge_parts:
        import jax
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("kaarme_parts")
        if c.pid == 0:
            total = merge_parts(args.output_file, c.nproc)
            print(f"merged {total} k-mers -> {args.output_file}", flush=True)
        multihost_utils.sync_global_devices("kaarme_done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
