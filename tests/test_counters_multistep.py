"""Multi-superstep streaming counters against the golden oracle at
several ratios of distinct-store prefix to superstep batch: prefix
much smaller than the batch (growth and replay), equal, and several
times larger (the prefix dominates each merge)."""

import numpy as np
import pytest

from kaarme_tpu.models.skm_counter import SkmCounter, SkmCounterConfig
from kaarme_tpu.models.sort_counter import SortCounterConfig, SortKmerCounter
from kaarme_tpu.utils import codec


def _reads(rng, glen, n_reads, read_len):
    genome = rng.integers(0, 4, size=glen, dtype=np.int64).astype(np.uint8)
    starts = rng.integers(0, glen - read_len, size=n_reads)
    stream = np.full((n_reads, read_len + 1), 4, np.uint8)
    stream[:, :read_len] = genome[starts[:, None] + np.arange(read_len)]
    return stream.reshape(-1)


# (batch_windows log2, prefix_cap log2): prefix/batch = 1/4, 1, 4, 8
RATIOS = [(12, 10), (11, 11), (10, 12), (10, 13)]


@pytest.mark.parametrize("blog2,plog2", RATIOS)
@pytest.mark.parametrize("pipeline", ["classic", "skm"])
def test_multistep_counter_golden(pipeline, blog2, plog2):
    k = 31
    rng = np.random.default_rng(blog2 * 16 + plog2)
    codes = _reads(rng, 3000, 160, 100)      # ~5x coverage, ~11k windows
    kw = dict(k=k, batch_windows=1 << blog2, rows=1 << 5,
              superbatch_batches=1, prefix_cap=1 << plog2,
              min_abundance=1)
    if pipeline == "skm":
        c = SkmCounter(SkmCounterConfig(**kw)).count_codes(codes)
    else:
        c = SortKmerCounter(SortCounterConfig(**kw)).count_codes(codes)
    assert c.stats["batches"] >= 2
    assert c.as_dict() == codec.golden_count(codes, k)
