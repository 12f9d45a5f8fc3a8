"""Native C++ runtime vs python oracle agreement tests."""

import os

import numpy as np
import pytest

from raconx.native import loader

if not loader.available():
    pytest.skip("native runtime unavailable", allow_module_level=True)

from raconx.native import bindings
from raconx.ops import nw_host, poa_host
from raconx.core.breakpoints import breaking_points_from_ops


def _rand_pair(rng, min_len=1, max_len=300, mut=0.15):
    t = rng.integers(65, 69, rng.integers(min_len, max_len)).astype(np.uint8)
    q = t.copy()
    # mutate
    n_mut = max(1, int(len(q) * mut))
    for _ in range(n_mut):
        kind = rng.integers(0, 3)
        pos = int(rng.integers(0, len(q)))
        if kind == 0:
            q[pos] = rng.integers(65, 69)
        elif kind == 1 and len(q) > 2:
            q = np.delete(q, pos)
        else:
            q = np.insert(q, pos, rng.integers(65, 69))
    return q, t


def test_edit_distance_matches_oracle():
    rng = np.random.default_rng(1)
    for _ in range(30):
        q, t = _rand_pair(rng)
        assert bindings.edit_distance(q, t) == nw_host.edit_distance(q, t)


def test_edit_distance_large_divergence():
    rng = np.random.default_rng(2)
    a = rng.integers(65, 69, 500).astype(np.uint8)
    b = rng.integers(65, 69, 700).astype(np.uint8)
    assert bindings.edit_distance(a, b) == nw_host.edit_distance(a, b)


def test_align_batch_edit_mode_scores():
    rng = np.random.default_rng(3)
    qs, ts = [], []
    for _ in range(10):
        q, t = _rand_pair(rng)
        qs.append(q)
        ts.append(t)
    qoff = np.zeros(11, np.int64)
    toff = np.zeros(11, np.int64)
    for i in range(10):
        qoff[i + 1] = qoff[i] + len(qs[i])
        toff[i + 1] = toff[i] + len(ts[i])
    ops, off, counts = bindings.align_batch(
        np.concatenate(qs), qoff, np.concatenate(ts), toff, 0, -1, -1, True, 2)
    from tests.test_nw_host import ops_consistent, score_of_ops
    for i in range(10):
        o = ops[off[i] : off[i] + counts[i]].tolist()
        assert ops_consistent(o, len(qs[i]), len(ts[i]))
        d = -score_of_ops(o, qs[i], ts[i], 0, -1, -1)
        assert d == nw_host.edit_distance(qs[i], ts[i])


def test_align_batch_nw_mode_matches_oracle_exactly():
    rng = np.random.default_rng(4)
    for scores in [(3, -5, -4), (5, -4, -8)]:
        qs, ts = [], []
        for _ in range(8):
            q, t = _rand_pair(rng, max_len=120)
            qs.append(q)
            ts.append(t)
        qoff = np.zeros(9, np.int64)
        toff = np.zeros(9, np.int64)
        for i in range(8):
            qoff[i + 1] = qoff[i] + len(qs[i])
            toff[i + 1] = toff[i] + len(ts[i])
        ops, off, counts = bindings.align_batch(
            np.concatenate(qs), qoff, np.concatenate(ts), toff, *scores,
            False, 1)
        for i in range(8):
            got = ops[off[i] : off[i] + counts[i]].tolist()
            _, want = nw_host.nw_align(qs[i], ts[i], *scores)
            assert got == want.tolist(), f"item {i} scores {scores}"


def test_breaking_points_batch_matches_oracle():
    rng = np.random.default_rng(5)
    n = 6
    qs, ts = [], []
    for _ in range(n):
        q, t = _rand_pair(rng, min_len=200, max_len=400, mut=0.1)
        qs.append(q)
        ts.append(t)
    qoff = np.zeros(n + 1, np.int64)
    toff = np.zeros(n + 1, np.int64)
    for i in range(n):
        qoff[i + 1] = qoff[i] + len(qs[i])
        toff[i + 1] = toff[i] + len(ts[i])
    strand = np.zeros(n, np.uint8)
    q_begin = np.zeros(n, np.int64)
    q_end = qoff[1:] - qoff[:-1]
    q_length = q_end.copy()
    t_begin = np.zeros(n, np.int64)
    t_end = toff[1:] - toff[:-1]
    quads, off, counts = bindings.breaking_points_batch(
        np.concatenate(qs), qoff, np.concatenate(ts), toff, strand, q_begin,
        q_end, q_length, t_begin, t_end, 64, 2)
    for i in range(n):
        _, ops = nw_host.nw_align(qs[i], ts[i], 0, -1, -1)
        want = breaking_points_from_ops(ops, False, 0, int(q_end[i]),
                                        int(q_length[i]), 0, int(t_end[i]), 64)
        got = quads[off[i] : off[i] + counts[i]]
        assert got.tolist() == want.tolist(), f"item {i}"


def test_native_parsers_match_python(data_dir):
    from raconx.io import fastx, overlaps_io
    from raconx.core.store import SequenceStoreBuilder

    # fastq
    p = os.path.join(data_dir, "sample_reads.fastq.gz")
    b = SequenceStoreBuilder()
    fastx.parse_fastq(p, b)
    py = b.finish()
    nat = fastx.FastqParser(p).parse_store()
    assert nat.names == py.names
    assert np.array_equal(nat.blob, py.blob)
    assert np.array_equal(nat.qual_blob, py.qual_blob)
    assert np.array_equal(nat.data_off, py.data_off)

    # fasta
    p = os.path.join(data_dir, "sample_layout.fasta.gz")
    b = SequenceStoreBuilder()
    fastx.parse_fasta(p, b)
    py = b.finish()
    nat = fastx.FastaParser(p).parse_store()
    assert nat.names == py.names
    assert np.array_equal(nat.blob, py.blob)

    # paf
    p = os.path.join(data_dir, "sample_overlaps.paf.gz")
    py_t = overlaps_io.parse_paf(p)
    na_t = overlaps_io.parse_native(p, 0)
    assert len(py_t) == len(na_t)
    assert py_t.q_names == na_t.q_names
    for k in ("q_begin", "q_end", "q_length", "t_begin", "t_end", "length"):
        assert np.array_equal(getattr(py_t, k), getattr(na_t, k)), k
    assert np.array_equal(py_t.strand, na_t.strand)
    assert np.allclose(py_t.error, na_t.error)

    # mhap
    p = os.path.join(data_dir, "sample_ava_overlaps.mhap.gz")
    py_t = overlaps_io.parse_mhap(p)
    na_t = overlaps_io.parse_native(p, 1)
    assert len(py_t) == len(na_t)
    for k in ("q_id", "t_id", "q_begin", "q_end", "t_begin", "t_end"):
        assert np.array_equal(getattr(py_t, k), getattr(na_t, k)), k

    # sam
    p = os.path.join(data_dir, "sample_overlaps.sam.gz")
    py_t = overlaps_io.parse_sam(p)
    na_t = overlaps_io.parse_native(p, 2)
    assert len(py_t) == len(na_t)
    assert py_t.cigars == na_t.cigars
    for k in ("q_begin", "q_end", "q_length", "t_begin", "t_end"):
        assert np.array_equal(getattr(py_t, k), getattr(na_t, k)), k
    assert np.array_equal(py_t.is_valid, na_t.is_valid)


def _consensus_native(backbone, layers, tgs, trim, scores):
    """Single-window consensus through the native batch API."""
    n_lay = len(layers)
    bb = np.frombuffer(backbone, np.uint8)
    bb_off = np.array([0, len(bb)], np.int64)
    bbw = np.zeros(len(bb), np.int32)
    lay_off = np.zeros(n_lay + 1, np.int64)
    parts, wparts, begins, ends = [], [], [], []
    for i, (d, q, b, e) in enumerate(layers):
        parts.append(d)
        wparts.append(q.astype(np.int32) - 33 if q is not None
                      else np.ones(len(d), np.int32))
        begins.append(b)
        ends.append(e)
        lay_off[i + 1] = lay_off[i] + len(d)
    out_blob, out_off, out_len, out_pol = bindings.consensus_batch(
        bb, bb_off, bbw, np.zeros(1, np.int64), np.zeros(1, np.int32),
        np.array([0, n_lay], np.int64),
        np.concatenate(parts) if parts else np.zeros(0, np.uint8), lay_off,
        np.concatenate(wparts) if wparts else np.zeros(0, np.int32),
        np.array(begins, np.int32), np.array(ends, np.int32), None, None,
        tgs, trim, scores[0], scores[1], scores[2], 1,
        np.array([2 * len(bb) + 512], np.int64))
    return out_blob.tobytes()[: int(out_len[0])], bool(out_pol[0])


def test_consensus_matches_python_oracle():
    rng = np.random.default_rng(6)
    for trial in range(8):
        w = int(rng.integers(50, 150))
        true = rng.integers(65, 69, w).astype(np.uint8)
        backbone = true.copy()
        for pos in rng.choice(w, 3, replace=False):
            backbone[pos] = rng.integers(65, 69)
        layers = []
        for _ in range(int(rng.integers(2, 8))):
            read = true.copy()
            for pos in rng.choice(w, 2, replace=False):
                read[pos] = rng.integers(65, 69)
            layers.append((read, None, 0, w - 1))
        want, want_ok = poa_host.consensus_window(
            backbone, None, layers, True, True, 3, -5, -4)
        got, got_ok = _consensus_native(backbone.tobytes(), layers, True,
                                        True, (3, -5, -4))
        assert got == want, f"trial {trial}"
        assert got_ok == want_ok


def test_compose_slots_matches_numpy():
    from raconx.native import bindings

    rng = np.random.default_rng(9)
    n_win = 17
    lens = rng.integers(1, 40, n_win).astype(np.int64)
    bb_off = np.zeros(n_win + 1, np.int64)
    np.cumsum(lens, out=bb_off[1:])
    slots = rng.integers(0, 1000, int(bb_off[-1])).astype(np.int64)
    new_len = rng.integers(0, 50, n_win).astype(np.int64)
    src_off = np.zeros(n_win, np.int64)
    np.cumsum(new_len[:-1], out=src_off[1:])
    local = rng.integers(0, 60, int(new_len.sum())).astype(np.int32)

    got, got_off = bindings.compose_slots(slots, bb_off, lens, local,
                                          src_off, new_len, 2)
    # numpy reference: the fancy-index chain the native pass replaced
    wz_e = np.repeat(np.arange(n_win, dtype=np.int64), new_len)
    want = slots[bb_off[wz_e]
                 + np.minimum(local.astype(np.int64), lens[wz_e] - 1)]
    assert np.array_equal(got, want)
    assert np.array_equal(np.diff(got_off), new_len)


def test_project_spans_matches_reference_rule():
    from raconx.native import bindings

    rng = np.random.default_rng(10)
    n_win = 9
    lens = rng.integers(3, 60, n_win).astype(np.int64)
    bb_off = np.zeros(n_win + 1, np.int64)
    np.cumsum(lens, out=bb_off[1:])
    # ascending (with duplicates) per-window slot runs
    slots = np.concatenate([
        np.sort(rng.integers(0, 100, int(lens[z]))) for z in range(n_win)
    ]).astype(np.int64)
    n_items = 200
    wz = rng.integers(0, n_win, n_items).astype(np.int64)
    b = rng.integers(0, 100, n_items).astype(np.int64)
    e = np.minimum(99, b + rng.integers(0, 100, n_items)).astype(np.int64)

    s0, s1 = bindings.project_spans(slots, bb_off, wz, b, e, 2)
    for i in range(n_items):
        z = wz[i]
        run = slots[bb_off[z] : bb_off[z + 1]]
        n = len(run)
        wb = int(np.searchsorted(run, b[i], side="left"))
        we = int(np.searchsorted(run, e[i], side="right")) - 1
        wb = min(max(wb, 0), n - 1)
        we = max(wb, min(we, n - 1))
        if wb < 0.01 * n and we > n - 0.01 * n:
            wb, we = 0, n - 1
        assert (s0[i], s1[i]) == (wb, we), i


@pytest.mark.parametrize("seed,rate", [(1, 0.04), (2, 0.04), (3, 0.25)])
def test_long_edit_align_uses_dp_tie_order(seed, rate):
    """Overlaps too big for the direct banded DP go through the wavefront
    aligner; its traceback must pick the DP's own path among co-optimal
    alignments (DIAG > UP > LEFT from the end), which is what the device
    Myers walk emits — the align stage's output must not depend on the
    backend. rate 0.25 (distance 1755) is past the resident-front budget,
    so the traceback recomputes fronts from checkpoints."""
    from raconx.ops.nw_host import nw_align

    acgt = np.frombuffer(b"ACGT", np.uint8)
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, 4000)
    u = rng.random(len(t))
    q = np.where(u < rate, rng.integers(0, 4, len(t)), t)
    q = np.delete(q, np.flatnonzero((u >= rate) & (u < 2 * rate)))
    q = np.insert(q, np.flatnonzero(rng.random(len(q)) < rate), 2)
    qa, ta = acgt[q], acgt[t]
    ops, off, cnt = bindings.align_batch(
        qa, np.array([0, len(qa)]), ta, np.array([0, len(ta)]), 0, -1, -1,
        True, 1)
    _, want = nw_align(qa, ta, 0, -1, -1)
    assert np.array_equal(ops[: cnt[0]], want)
