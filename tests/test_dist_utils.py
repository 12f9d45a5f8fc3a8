"""Unit tests for the multi-host helpers (single-process semantics) and the
honest progress bar."""

import io
import sys

import numpy as np

from raconx.parallel import dist
from raconx.utils.logger import Logger


def test_shard_range_partitions_exactly():
    for n in (0, 1, 7, 100):
        for p in (1, 2, 3, 8):
            spans = [dist.shard_range(n, index=i, count=p) for i in range(p)]
            assert spans[0][0] == 0 and spans[-1][1] == n
            for (a, b), (c, d) in zip(spans, spans[1:]):
                assert b == c and b - a >= 0
            sizes = [b - a for a, b in spans]
            assert max(sizes) - min(sizes) <= 1


def test_allgather_ragged_single_process():
    items = [np.arange(3, dtype=np.int64).reshape(-1),
             np.zeros(0, np.int64),
             np.arange(5, dtype=np.int64)]
    out = dist.allgather_ragged(items, np.int64)
    assert len(out) == 3
    for a, b in zip(items, out):
        assert (a == b).all()


def test_allgather_ragged_quads():
    items = [np.arange(8, dtype=np.int64).reshape(2, 4),
             np.zeros((0, 4), np.int64)]
    out = dist.allgather_ragged(items, np.int64, trailing=(4,))
    assert out[0].shape == (2, 4) and out[1].shape == (0, 4)
    assert (out[0] == items[0]).all()


def test_bar_progress_draws_each_bin_once():
    log = Logger()
    err = io.StringIO()
    old = sys.stderr
    sys.stderr = err
    try:
        total = 137
        done = 0
        while done < total:
            done += 10
            log.bar_progress("stage", min(done, total), total)
    finally:
        sys.stderr = old
    out = err.getvalue()
    assert out.count("[====================]") == 1  # filled exactly once
    assert "100%" in out
    # monotone: every 5% step appears at most once
    for pct in range(5, 101, 5):
        assert out.count(f" {pct}%") == 1


def test_gather_to0_single_process_fallback():
    """gather_ragged_to0 / gather_blob_to0 must degrade to the allgather
    path (returning every item, in order) when no KV client / multi-process
    runtime exists — the polish() path uses them unconditionally under
    dist.is_active(), and single-process tests reach them via the public
    API too."""
    import numpy as np
    from raconx.parallel import dist

    items = [np.arange(3, dtype=np.uint8), np.zeros(0, np.uint8),
             np.array([7, 9], np.uint8)]
    out = dist.gather_ragged_to0(items, np.uint8)
    assert len(out) == 3
    for a, b in zip(items, out):
        assert np.array_equal(a, b)
    blob = dist.gather_blob_to0(np.arange(5, dtype=np.int64))
    assert len(blob) == 1 and np.array_equal(blob[0], np.arange(5))
