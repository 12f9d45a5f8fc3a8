import numpy as np
import pytest

from raconx.core.breakpoints import OP_MATCH, OP_INS, OP_DEL
from raconx.ops.nw_host import nw_align, edit_distance


def brute_nw(q, t, m, x, g):
    import itertools
    H = np.zeros((len(q) + 1, len(t) + 1), dtype=np.int64)
    H[0, :] = np.arange(len(t) + 1) * g
    H[:, 0] = np.arange(len(q) + 1) * g
    for i in range(1, len(q) + 1):
        for j in range(1, len(t) + 1):
            s = m if q[i - 1] == t[j - 1] else x
            H[i, j] = max(H[i - 1, j - 1] + s, H[i - 1, j] + g, H[i, j - 1] + g)
    return int(H[len(q), len(t)])


def ops_consistent(ops, qlen, tlen):
    qc = sum(r for o, r in ops if o in (OP_MATCH, OP_INS))
    tc = sum(r for o, r in ops if o in (OP_MATCH, OP_DEL))
    return qc == qlen and tc == tlen


def score_of_ops(ops, q, t, m, x, g):
    s = 0
    qi = ti = 0
    for op, run in ops:
        if op == OP_MATCH:
            for _ in range(run):
                s += m if q[qi] == t[ti] else x
                qi += 1
                ti += 1
        elif op == OP_INS:
            s += g * run
            qi += run
        else:
            s += g * run
            ti += run
    return s


@pytest.mark.parametrize("scores", [(0, -1, -1), (3, -5, -4), (5, -4, -8)])
def test_nw_matches_brute_force(scores):
    rng = np.random.default_rng(42)
    for _ in range(20):
        q = rng.integers(65, 69, rng.integers(1, 40)).astype(np.uint8)
        t = rng.integers(65, 69, rng.integers(1, 40)).astype(np.uint8)
        score, ops = nw_align(q, t, *scores)
        assert score == brute_nw(q, t, *scores)
        assert ops_consistent(ops.tolist(), len(q), len(t))
        assert score_of_ops(ops.tolist(), q, t, *scores) == score


def test_nw_identical():
    q = np.frombuffer(b"ACGTACGT", dtype=np.uint8)
    score, ops = nw_align(q, q, 3, -5, -4)
    assert score == 24
    assert ops.tolist() == [[OP_MATCH, 8]]


def test_edit_distance():
    assert edit_distance(b"kitten", b"sitting") == 3
    assert edit_distance(b"", b"abc") == 3
    assert edit_distance(b"abc", b"abc") == 0
    rng = np.random.default_rng(0)
    for _ in range(10):
        a = rng.integers(65, 69, rng.integers(0, 50)).astype(np.uint8)
        b = rng.integers(65, 69, rng.integers(0, 50)).astype(np.uint8)
        score, _ = nw_align(a, b, 0, -1, -1)
        assert edit_distance(a, b) == -score
