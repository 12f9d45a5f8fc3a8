"""Unit tests of reference-exact record semantics: SAM accounting, overlap
filtering, breaking-point walks, reverse complements."""

import numpy as np
import pytest

from raconx.core.breakpoints import (breaking_points_from_cigar,
                                        cigar_to_ops, OP_MATCH, OP_INS, OP_DEL)
from raconx.core.overlaps import OverlapTable
from raconx.core.store import SequenceStoreBuilder
from raconx.io.overlaps_io import sam_cigar_accounting


def test_sam_accounting_forward():
    # 5S 10M 2I 3D 10M 4S on target from pos 100 (0-based)
    q_begin, q_end, q_length, t_end, length, error = sam_cigar_accounting(
        b"5S10M2I3D10M4S", strand=False, t_begin=100)
    assert q_begin == 5
    assert q_end == 5 + 22
    assert q_length == 9 + 22
    assert t_end == 100 + 23
    assert length == 23
    assert abs(error - (1 - 22 / 23)) < 1e-12


def test_sam_accounting_reverse_flip():
    q_begin, q_end, q_length, t_end, _, _ = sam_cigar_accounting(
        b"5S10M4S", strand=True, t_begin=0)
    # forward coords: begin 5, end 15, len 19 -> flipped: begin 4, end 14
    assert (q_begin, q_end, q_length) == (4, 14, 19)
    assert t_end == 10


def test_sam_accounting_no_leading_clip():
    q_begin, *_ = sam_cigar_accounting(b"10M5S", strand=False, t_begin=0)
    assert q_begin == 0


def test_cigar_to_ops():
    ops = cigar_to_ops(b"3M2I4D1X2=")
    assert ops.tolist() == [[OP_MATCH, 3], [OP_INS, 2], [OP_DEL, 4],
                            [OP_MATCH, 1], [OP_MATCH, 2]]


def test_breaking_points_walk():
    # target windows of 10; alignment 25M from t=5, q=0
    bp = breaking_points_from_cigar(b"25M", strand=False, q_begin=0, q_end=25,
                                    q_length=25, t_begin=5, t_end=30,
                                    window_length=10)
    # windows split at t=9, 19, 29 (inclusive ends)
    assert bp.tolist() == [
        [5, 0, 10, 5],    # first window: t 5..9, q 0..4
        [10, 5, 20, 15],  # t 10..19
        [20, 15, 30, 25],
    ]


def test_breaking_points_deletion_at_boundary():
    # deletion spanning a window end: no match recorded in second window until
    # after the D run
    bp = breaking_points_from_cigar(b"8M4D8M", strand=False, q_begin=0,
                                    q_end=16, q_length=16, t_begin=0, t_end=20,
                                    window_length=10)
    assert bp.tolist() == [
        [0, 0, 8, 8],      # matches t 0..7
        [12, 8, 20, 16],   # matches resume at t=12
    ]


def _mk_table(rows):
    cols = {k: [] for k in ("q_id", "t_id", "q_begin", "q_end", "q_length",
                            "t_begin", "t_end", "t_length", "strand", "error",
                            "length", "is_valid")}
    for r in rows:
        for k, v in r.items():
            cols[k].append(v)
        for k in cols:
            if k not in r:
                cols[k].append(1 if k == "is_valid" else 0)
    t = OverlapTable()
    t.finalize_from_lists(cols)
    return t


def test_filter_error_and_self():
    t = _mk_table([
        dict(q_id=0, t_id=1, error=0.1, length=10),
        dict(q_id=1, t_id=1, error=0.1, length=10),   # self overlap
        dict(q_id=2, t_id=1, error=0.5, length=10),   # too high error
    ])
    keep = t.filter_invalid(0.3, keep_longest_per_query=False)
    assert keep.tolist() == [True, False, False]


def test_filter_keep_longest_per_run():
    t = _mk_table([
        dict(q_id=0, t_id=9, error=0.0, length=10),
        dict(q_id=0, t_id=9, error=0.0, length=30),
        dict(q_id=0, t_id=9, error=0.0, length=20),
        dict(q_id=1, t_id=9, error=0.0, length=5),
        dict(q_id=0, t_id=9, error=0.0, length=7),  # new run of q 0
    ])
    keep = t.filter_invalid(0.3, keep_longest_per_query=True)
    assert keep.tolist() == [False, True, False, True, True]


def test_filter_tie_later_wins():
    t = _mk_table([
        dict(q_id=0, t_id=9, error=0.0, length=10),
        dict(q_id=0, t_id=9, error=0.0, length=10),
    ])
    keep = t.filter_invalid(0.3, keep_longest_per_query=True)
    assert keep.tolist() == [False, True]


def test_reverse_complement():
    b = SequenceStoreBuilder()
    b.add(b"s", b"ACGTN", b"!!#$%")
    store = b.finish()
    assert bytes(store.reverse_complement(0)) == b"NACGT"
    assert bytes(store.reverse_quality(0)) == b"%$#!!"
