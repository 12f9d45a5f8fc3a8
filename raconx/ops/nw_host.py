"""Host (numpy) linear-gap Needleman-Wunsch with op-list traceback.

This is the pure-Python oracle for both device kernels and the native C++
aligner. With scores (0,-1,-1) it minimizes edit distance (the reference's
edlib NW role, src/overlap.cpp:205-224); with (match,mismatch,gap) it plays
the layer-vs-backbone role of spoa's kNW engine (src/window.cpp:94-101).

Rows are query positions i (0..m), columns are target positions j (0..n).
The in-row horizontal dependency is vectorized with the max-plus prefix-scan
identity  H[i,j] = j*g + max_{k<=j}(cand[i,k] - k*g),  the same trick the
device sweep uses per row (ops/nw_kernel.py).

Tie-breaking (standardized across py/native/device backends): during
traceback prefer DIAG, then UP (consume query), then LEFT (consume target).
"""

from __future__ import annotations

import numpy as np

from ..core.breakpoints import OP_MATCH, OP_INS, OP_DEL

NEG_INF = -(1 << 29)


def nw_align(query: np.ndarray, target: np.ndarray, match: int, mismatch: int,
             gap: int, del_cost: np.ndarray | None = None
             ) -> tuple[int, np.ndarray]:
    """Global alignment; returns (score, ops) with ops rows (op, run).

    del_cost, when given, is the per-target-column cost of consuming t[j] by
    deletion (normally `gap`; 0 marks the refinement passes' "optional"
    columns). The horizontal closure generalizes the max-plus prefix scan to
    cumulative costs Gc: H[i,j] = Gc[j] + max_{k<=j}(cand[i,k] - Gc[k]).
    """
    q = np.asarray(query, dtype=np.uint8)
    t = np.asarray(target, dtype=np.uint8)
    m, n = len(q), len(t)
    if del_cost is None:
        del_cost = np.full(n, gap, dtype=np.int32)
    Gc = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(del_cost, out=Gc[1:])
    H = np.empty((m + 1, n + 1), dtype=np.int32)
    H[0] = Gc
    for i in range(1, m + 1):
        sub_row = np.where(t == q[i - 1], np.int32(match), np.int32(mismatch))
        cand = np.empty(n + 1, dtype=np.int32)
        cand[0] = i * gap
        # diag and up candidates
        np.maximum(H[i - 1, :n] + sub_row, H[i - 1, 1:] + gap, out=cand[1:])
        # horizontal closure via max-plus prefix scan
        H[i] = np.maximum.accumulate(cand - Gc) + Gc
    score = int(H[m, n])

    # traceback, re-deriving moves from H (DIAG > UP > LEFT)
    ops: list[tuple[int, int]] = []
    i, j = m, n
    while i > 0 or j > 0:
        h = H[i, j]
        if i > 0 and j > 0 and h == H[i - 1, j - 1] + (
                match if q[i - 1] == t[j - 1] else mismatch):
            op = OP_MATCH
            i -= 1
            j -= 1
        elif i > 0 and h == H[i - 1, j] + gap:
            op = OP_INS
            i -= 1
        else:
            op = OP_DEL
            j -= 1
        if ops and ops[-1][0] == op:
            ops[-1] = (op, ops[-1][1] + 1)
        else:
            ops.append((op, 1))
    ops.reverse()
    return score, np.asarray(ops, dtype=np.int32).reshape(-1, 2)


def edit_distance(a: np.ndarray | bytes, b: np.ndarray | bytes) -> int:
    """Distance-only Myers-style computation via numpy rows (exact)."""
    a = np.frombuffer(a, dtype=np.uint8) if isinstance(a, (bytes, bytearray)) else a
    b = np.frombuffer(b, dtype=np.uint8) if isinstance(b, (bytes, bytearray)) else b
    m, n = len(a), len(b)
    if m == 0:
        return n
    if n == 0:
        return m
    prev = np.arange(n + 1, dtype=np.int32)
    for i in range(1, m + 1):
        sub = (b != a[i - 1]).astype(np.int32)
        cand = np.empty(n + 1, dtype=np.int32)
        cand[0] = i
        np.minimum(prev[:n] + sub, prev[1:] + 1, out=cand[1:])
        idx = np.arange(n + 1, dtype=np.int32)
        prev = np.minimum.accumulate(cand - idx) + idx
    return int(prev[n])
