"""Sharded sort-backend counter: golden equality over a virtual mesh."""

import numpy as np
import pytest

from kaarme_tpu.parallel.sharded import make_mesh
from kaarme_tpu.parallel.sharded_sort import ShardedSortConfig, ShardedSortCounter
from kaarme_tpu.utils import codec


def _counter(k, ndev=8, **kw):
    kw.setdefault("batch_windows", 1 << 10)
    kw.setdefault("rows", 1 << 5)
    kw.setdefault("prefix_cap", 1 << 12)
    kw.setdefault("min_abundance", 1)
    return ShardedSortCounter(ShardedSortConfig(k=k, **kw), make_mesh(ndev))


def _stream(rng, n, p_sep=0.02):
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    codes[rng.random(n) < p_sep] = 4
    return codes


@pytest.mark.parametrize("k", [13, 31, 51])
def test_sharded_golden_equality(k):
    rng = np.random.default_rng(k)
    codes = _stream(rng, 40000)
    c = _counter(k).count_codes(codes)
    assert c.as_dict() == codec.golden_count(codes, k)


def test_sharded_matches_single_device():
    from kaarme_tpu.models.sort_counter import SortCounterConfig, SortKmerCounter

    k = 21
    rng = np.random.default_rng(1)
    codes = _stream(rng, 60000, p_sep=0.01)
    sharded = _counter(k).count_codes(codes).as_dict()
    single = SortKmerCounter(SortCounterConfig(
        k=k, batch_windows=1 << 12, rows=1 << 6, prefix_cap=1 << 13,
        min_abundance=1)).count_codes(codes).as_dict()
    assert sharded == single


def test_sharded_multi_superbatch_and_merge():
    k = 11
    rng = np.random.default_rng(2)
    # > ndev * batch_windows codes so multiple sharded flushes happen
    codes = _stream(rng, 8 * 1024 * 4 + 4711, p_sep=0.01)
    c = _counter(k, merge_every=2)
    for i in range(0, codes.shape[0], 5000):
        c.add_codes(codes[i : i + 5000])
    c.finish()
    assert c.stats["batches"] >= 2
    assert c.as_dict() == codec.golden_count(codes, k)


def test_sharded_find_and_output(tmp_path):
    k = 15
    rng = np.random.default_rng(3)
    codes = _stream(rng, 20000)
    c = _counter(k).count_codes(codes)
    g = codec.golden_count(codes, k)
    some = list(g)[:10]
    assert c.find(some) == [g[s] for s in some]
    out = tmp_path / "out.txt"
    n = c.write_output(str(out))
    got = {ln.split()[0]: int(ln.split()[1]) for ln in out.read_text().splitlines()}
    assert len(got) == n and got == g


def test_sharded_growth():
    k = 9
    rng = np.random.default_rng(4)
    codes = _stream(rng, 120000, p_sep=0.005)
    c = _counter(k, prefix_cap=1 << 8)
    c.count_codes(codes)
    assert c.stats["grow_events"] >= 1
    assert c.as_dict() == codec.golden_count(codes, k)


def test_sharded_add_after_finalize_raises():
    import numpy as np
    import pytest as _pytest

    c = _counter(9)
    c.count_codes(np.zeros(2000, np.uint8))
    c.dump()  # triggers finalize_exchange
    with _pytest.raises(RuntimeError):
        c.add_codes(np.zeros(9000, np.uint8))


def test_sharded_sort_checkpoint_roundtrip(tmp_path):
    k = 13
    rng = np.random.default_rng(5)
    codes = _stream(rng, 50000)
    half = codes.shape[0] // 2
    path = str(tmp_path / "ck.npz")

    c = _counter(k)
    c.add_codes(codes[:half])
    c.save(path)                     # flushes buffered input, no exchange
    # resume on the SAME counter: save must not forbid further input
    c.add_codes(codes[half:])
    c.finish()
    assert c.as_dict() == codec.golden_count(codes, k)

    # resume from disk on a fresh counter (different mesh size)
    c2 = ShardedSortCounter.load(
        path, ShardedSortConfig(k=k, batch_windows=1 << 10, rows=1 << 5,
                                prefix_cap=1 << 12, min_abundance=1),
        make_mesh(4))
    c2.add_codes(codes[half:])
    c2.finish()
    assert c2.as_dict() == codec.golden_count(codes, k)


def test_sharded_sort_checkpoint_after_finalize_raises(tmp_path):
    c = _counter(9)
    c.count_codes(np.zeros(2000, np.uint8))
    c.dump()
    with pytest.raises(RuntimeError):
        c.save(str(tmp_path / "x.npz"))


@pytest.mark.parametrize("winkeys", ["codes", "packed"])
def test_sharded_superstep_winkeys(winkeys):
    """Both window-key formulations compose with shard_map on the
    virtual mesh and stay golden."""
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 5, size=8 * (1 << 10) + 333).astype(np.uint8)
    cfg = ShardedSortConfig(k=17, batch_windows=1 << 10, rows=1 << 5,
                            prefix_cap=1 << 12, min_abundance=1,
                            winkeys=winkeys)
    c = ShardedSortCounter(cfg, make_mesh(8)).count_codes(codes)
    assert c.as_dict() == codec.golden_count(codes, 17)


@pytest.mark.parametrize("winkeys", ["codes", "packed"])
def test_sharded_checkpoint_duplication_heavy(tmp_path, winkeys):
    """Regression: checkpoint rows carry PARTIAL counts for the same key
    on several shards and are not globally sorted; load() must
    aggregate + sort before re-partitioning or the fused supersteps
    (c_last trick) silently corrupt counts."""
    k = 17
    rng = np.random.default_rng(21)
    base = rng.integers(0, 4, size=500).astype(np.uint8)
    codes = np.tile(np.concatenate([base, [4]]), 60)   # heavy duplication
    half = (codes.shape[0] // 2) & ~1023
    path = str(tmp_path / "ckd.npz")

    cfg = ShardedSortConfig(k=k, batch_windows=1 << 10, rows=1 << 5,
                            prefix_cap=1 << 12, min_abundance=1,
                            winkeys=winkeys)
    c = ShardedSortCounter(cfg, make_mesh(8))
    c.add_codes(codes[:half])
    c.save(path)
    c2 = ShardedSortCounter.load(
        path, ShardedSortConfig(k=k, batch_windows=1 << 10, rows=1 << 5,
                                prefix_cap=1 << 12, min_abundance=1,
                                winkeys=winkeys),
        make_mesh(4))
    c2.add_codes(codes[half:])
    c2.finish()
    assert c2.as_dict() == codec.golden_count(codes, k)
