"""Run segmentation + slot packing (ops/skm.py ``run_rows`` +
``pack_slots``) against the NumPy mirror ``runs_np`` across k, stream
size, slot budget S and separator density — including slot overflow,
where exactly the first S run starts of each tile survive — and the
counter's replay when a tile overflows its slots."""

import numpy as np
import jax.numpy as jnp
import pytest

from kaarme_tpu.models.skm_counter import SkmCounter, SkmCounterConfig
from kaarme_tpu.ops import skm, sortcount
from kaarme_tpu.utils import codec

SENT = 0xFFFFFFFF


def _stream(rng, n_codes, sep_every):
    """Reads sampled from a small genome (duplicate runs) with a
    separator every ``sep_every`` codes and a short N patch."""
    genome = rng.integers(0, 4, size=700, dtype=np.int64).astype(np.uint8)
    out = np.empty(n_codes, np.uint8)
    i = 0
    while i < n_codes:
        s = int(rng.integers(0, 700 - sep_every))
        ln = min(sep_every, n_codes - i)
        out[i: i + ln] = genome[s: s + ln]
        i += ln
        if i < n_codes:
            out[i] = 4
            i += 1
    out[n_codes // 3: n_codes // 3 + 3] = 4
    return out


def _expected(codes, k, n, S):
    """(row dict, max runs per tile) of the slotted rows pack_slots must
    produce: one row per run start, the first S starts of each tile."""
    runs, raw = skm.runs_np(codes, k, n)
    Wc = skm.content_words(k)
    per_tile, out = {}, {}
    for start, ell, valid in runs:
        t = start // skm.TILE
        o = per_tile.get(t, 0)
        per_tile[t] = o + 1
        if o >= S or not valid:
            continue
        span = ell + k - 1
        row = []
        for j in range(Wc):
            nb = min(max(span - 16 * j, 0), 16)
            mask = 0 if nb == 0 else ((1 << (2 * nb)) - 1) << (32 - 2 * nb)
            row.append(int(raw[start + 16 * j]) & mask)
        row.append((ell - 1) << skm.EBITS)
        key = tuple(row)
        out[key] = out.get(key, 0) + 1
    return out, max(per_tile.values())


@pytest.mark.parametrize("S", [96, 512])
@pytest.mark.parametrize("sep_every", [151, 40])
@pytest.mark.parametrize("k", [16, 31, 51])
def test_pack_slots_matches_numpy(k, sep_every, S):
    n = 2048
    rng = np.random.default_rng(k * 7 + sep_every + S)
    codes = _stream(rng, n + k - 1, sep_every)
    packed, _ = sortcount.pack_stream_np(codes)
    Wc = skm.content_words(k)
    need = (n + 16 * (Wc - 1)) // 16 + 2
    pk = np.zeros(max(need, packed.shape[0]), np.uint32)
    pk[: packed.shape[0]] = packed
    inval = (codes >= 4).astype(np.int32)

    b, cols = skm.run_rows(jnp.asarray(pk), jnp.asarray(inval), k, n)
    slotted, maxruns = skm.pack_slots(b, cols, n, S, k)
    exp, exp_max = _expected(codes, k, n, S)
    assert int(maxruns) == exp_max

    rows = np.stack([np.asarray(c) for c in slotted], axis=1)
    assert rows.shape[0] == (n // skm.TILE) * S
    got = {}
    emask = (1 << skm.EBITS) - 1
    for r in rows:
        if (r == SENT).all():
            continue
        key = tuple(int(x) for x in r[:-1]) + (int(r[-1]) & ~emask,)
        got[key] = got.get(key, 0) + (int(r[-1]) & emask)
    assert got == exp


def _coverage_stream(rng, glen, n_reads, read_len):
    genome = rng.integers(0, 4, size=glen, dtype=np.int64).astype(np.uint8)
    parts = []
    for _ in range(n_reads):
        s = int(rng.integers(0, glen - read_len))
        parts.append(genome[s: s + read_len])
        parts.append(np.full(1, 4, np.uint8))
    return np.concatenate(parts)


@pytest.mark.parametrize("k", [16, 51])
def test_counter_slot_overflow_replay(k):
    """A slot budget far below the runs per tile: every overflowing
    superstep is replayed at a larger S and the counts stay exact."""
    rng = np.random.default_rng(k)
    codes = _coverage_stream(rng, 900, 50, 100)
    cfg = SkmCounterConfig(k=k, batch_windows=1024, rows=512,
                           superbatch_batches=2, prefix_cap=1 << 13,
                           min_abundance=1, skm_slots=4)
    c = SkmCounter(cfg).count_codes(codes)
    assert c.stats["slot_grow_events"] >= 1
    assert c.as_dict() == codec.golden_count(codes, k)
