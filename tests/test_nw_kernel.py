"""Scored banded-NW sweep + device walk vs the host oracles.

On CPU the sweep is nw_band_batch_ref (plain jax.numpy, the twin the CUDA
kernel must reproduce bit for bit); the `gpu`-marked tests compare the CUDA
kernel with it on the card, at the consensus tiers' real widths."""

import numpy as np
import pytest

from raconx.native import bindings
from raconx.ops import nw_host
from raconx.ops.nw_kernel import (align_walk_batch, encode, nw_band_batch_ref,
                                  pack_codes4, pack_delbits, padded_batch,
                                  pad_items, walk_moves_device, walk_steps,
                                  PAD_CODE)
from raconx.ops.nw_walk import walk_moves
from test_nw_host import ops_consistent, score_of_ops

M_CAP = N_CAP = 128
W = 64
SCORES = [(5, -4, -8), (3, -5, -4), (0, -1, -1)]
ACGT = np.frombuffer(b"ACGT", np.uint8)


def _inputs(pairs, gap, cap, del_costs=None):
    B = len(pairs)
    q = np.full((B, cap), PAD_CODE, np.int32)
    t = np.full((B, cap), PAD_CODE, np.int32)
    gc = np.zeros((B, cap + 1), np.int32)
    dc8 = np.full((B, cap), gap, np.int8)
    for b, (qa, ta) in enumerate(pairs):
        q[b, : len(qa)] = encode(qa)
        t[b, : len(ta)] = encode(ta)
        dc = np.full(cap, gap, np.int32)
        if del_costs is not None and del_costs[b] is not None:
            dc[: len(ta)] = del_costs[b]
        dc8[b] = dc
        gc[b, 1:] = np.cumsum(dc)
    return q, t, gc, dc8


def _run(pairs, scores, del_costs=None, cap=M_CAP, w=W):
    q, t, gc, _ = _inputs(pairs, scores[2], cap, del_costs)
    moves, score = nw_band_batch_ref(q, t, gc, m_cap=cap, n_cap=cap,
                                     w_band=w, match=scores[0],
                                     mismatch=scores[1], gap=scores[2])
    moves = np.asarray(moves)
    score = np.asarray(score)
    return [(int(score[b, 0]),
             walk_moves(moves[b], len(qa), len(ta), cap, cap, w))
            for b, (qa, ta) in enumerate(pairs)]


def _mutate(rng, t, n_mut):
    q = t.copy()
    for _ in range(n_mut):
        kind = rng.integers(0, 3)
        pos = int(rng.integers(0, max(1, len(q))))
        if kind == 0 and len(q):
            q[pos] = rng.choice(ACGT)
        elif kind == 1 and len(q) > 2:
            q = np.delete(q, pos)
        else:
            q = np.insert(q, pos, rng.choice(ACGT))
    return q


def _pairs(rng, count, lo, hi, n_mut):
    pairs = []
    for _ in range(count):
        t = rng.choice(ACGT, int(rng.integers(lo, hi)))
        pairs.append((_mutate(rng, t, n_mut), t))
    return pairs


@pytest.mark.parametrize("cap,w", [(128, 64), (256, 128)])
@pytest.mark.parametrize("scores", SCORES)
def test_kernel_matches_oracle_scores_and_ops(scores, cap, w):
    rng = np.random.default_rng(11)
    pairs = _pairs(rng, 8, cap // 4, cap // 2, 4)
    for (q, t), (score, ops) in zip(pairs, _run(pairs, scores, cap=cap,
                                                w=w)):
        want_score, _ = nw_host.nw_align(q, t, *scores)
        # the sweep's score includes the deterministic pad tail
        pad_score = scores[0] * min(cap - len(q), cap - len(t)) + \
            scores[2] * abs((cap - len(q)) - (cap - len(t)))
        assert score == want_score + pad_score
        assert ops_consistent(ops.tolist(), len(q), len(t))
        assert score_of_ops(ops.tolist(), q, t, *scores) == want_score


def test_kernel_exact_ops_vs_oracle_easy():
    """With comfortable band margin and no near-band paths, tie-breaking
    matches the oracle exactly."""
    rng = np.random.default_rng(12)
    scores = (5, -4, -8)
    pairs = _pairs(rng, 6, 50, 51, 2)
    for (q, t), (score, ops) in zip(pairs, _run(pairs, scores)):
        _, want = nw_host.nw_align(q, t, *scores)
        assert ops.tolist() == want.tolist()


def test_kernel_per_column_deletion_costs():
    """Optional (zero-del-cost) columns: reads lacking the base skip it free;
    matches the oracle's percol mode."""
    scores = (5, -4, -8)
    t = np.frombuffer(b"AACCTTGG", np.uint8)
    # column 4 ('T') optional
    dc = np.full(len(t), scores[2], np.int32)
    dc[4] = 0
    qs = [b"AACCTTGG", b"AACCTGG", b"AACCGG"]
    pairs = [(np.frombuffer(x, np.uint8), t) for x in qs]
    results = _run(pairs, scores, del_costs=[dc] * 3)
    for (q, _), (score, ops) in zip(pairs, results):
        want_score, want_ops = nw_host.nw_align(q, t, *scores, del_cost=dc)
        assert ops_consistent(ops.tolist(), len(q), len(t))
        got_real = score - (scores[0] * min(M_CAP - len(q), N_CAP - len(t)) +
                            scores[2] * abs((M_CAP - len(q)) - (N_CAP - len(t))))
        assert got_real == want_score
        assert ops.tolist() == want_ops.tolist()


def test_kernel_identical_sequences():
    q = np.frombuffer(b"ACGTACGTACGT", np.uint8)
    results = _run([(q, q)], (5, -4, -8))
    score, ops = results[0]
    assert ops.tolist() == [[0, 12]]


def test_uplink_packing_roundtrip():
    """pack_codes4/pack_delbits (host) must invert exactly through the
    device-side unpackers."""
    import jax
    from raconx.ops.nw_kernel import unpack_codes4, unpack_delbits

    rng = np.random.default_rng(5)
    q8 = rng.integers(0, 6, (7, 256)).astype(np.int8)
    got = np.asarray(jax.jit(unpack_codes4, static_argnums=1)(
        pack_codes4(q8), 256))
    np.testing.assert_array_equal(got, q8)

    gap = -8
    dc8 = np.where(rng.random((7, 256)) < 0.3, 0, gap).astype(np.int8)
    got = np.asarray(jax.jit(unpack_delbits, static_argnums=(1, 2))(
        pack_delbits(dc8), 256, gap))
    np.testing.assert_array_equal(got, dc8.astype(np.int32))


@pytest.mark.parametrize("percol", [False, True])
@pytest.mark.parametrize("scores", SCORES)
def test_fused_walk_matches_host_walk(scores, percol):
    """The fused dispatch (unpack + sweep + device walk, packed 2-bit op
    stream, native decoder) gives the op lists of the host walker over the
    same moves, and those match the native C++ aligner."""
    rng = np.random.default_rng(21)
    gap = scores[2]
    pairs = _pairs(rng, 12, 40, 100, 5)
    dels = [None] * len(pairs)
    if percol:
        dels = [np.where(rng.random(len(t)) < 0.3, 0, gap).astype(np.int32)
                for _, t in pairs]
    q, t, gc, dc8 = _inputs(pairs, gap, M_CAP, dels)
    m = np.array([len(a) for a, _ in pairs], np.int32)
    n = np.array([len(b) for _, b in pairs], np.int32)
    payload, score = align_walk_batch(
        pack_codes4(q.astype(np.int8)), pack_codes4(t.astype(np.int8)),
        pack_delbits(dc8), m, n, m_cap=M_CAP, n_cap=N_CAP, w_band=W,
        match=scores[0], mismatch=scores[1], gap=gap, kernel=False)
    payload = np.asarray(payload)
    assert not payload[:, -1].any()
    ops, off, cnt = bindings.opstream_packed_to_ops_batch(
        np.ascontiguousarray(payload[:, :-1]), walk_steps(M_CAP, N_CAP, W),
        m, n, 2)
    want = _run(pairs, scores, del_costs=dels)
    qoff = np.concatenate([[0], np.cumsum(m)]).astype(np.int64)
    toff = np.concatenate([[0], np.cumsum(n)]).astype(np.int64)
    dblob = np.concatenate([dc8[b, :n[b]] for b in range(len(pairs))])
    hops, hoff, hcnt = bindings.align_batch_percol(
        np.concatenate([a for a, _ in pairs]), qoff,
        np.concatenate([b for _, b in pairs]), toff,
        dblob.astype(np.int32), scores[0], scores[1], gap, 2)
    for b in range(len(pairs)):
        got = ops[off[b] : off[b] + cnt[b]]
        assert np.array_equal(got, want[b][1]), b
        assert np.array_equal(got, hops[hoff[b] : hoff[b] + hcnt[b]]), b


def test_walk_flags_band_escape():
    """A path that must leave the band (length mismatch past W/2) is
    flagged escaped for the host fallback, never emitted truncated."""
    rng = np.random.default_rng(3)
    t = rng.choice(ACGT, 110)
    pairs = [(t[:30].copy(), t), (t.copy(), t)]
    q, tt, gc, _ = _inputs(pairs, -1, M_CAP)
    moves, _ = nw_band_batch_ref(q, tt, gc, m_cap=M_CAP, n_cap=N_CAP,
                                 w_band=W, match=0, mismatch=-1, gap=-1)
    _, esc = walk_moves_device(moves, np.array([30, 110], np.int32),
                               np.array([110, 110], np.int32), m_cap=M_CAP,
                               n_cap=N_CAP, w_band=W,
                               max_steps=walk_steps(M_CAP, N_CAP, W))
    assert np.asarray(esc).tolist() == [True, False]


@pytest.mark.parametrize("B,fixed_b,mesh,want", [
    (1, None, 1, 16), (17, None, 1, 32), (1000, None, 1, 1024),
    (1000, 4096, 1, 4096), (5000, 4096, 1, 5000), (20, None, 8, 32),
    (30, 30, 4, 32)])
def test_padded_batch(B, fixed_b, mesh, want):
    assert padded_batch(B, fixed_b, mesh) == want


def test_pad_items_are_empty_pad_rows():
    q4 = np.zeros((3, 8), np.uint8)
    m = np.array([5, 6, 7])
    q4p, t4p, mp, np_ = pad_items(5, q4, q4, m, m)
    assert q4p.shape == (5, 8) and (q4p[3:] == 0x55).all()
    assert mp.tolist() == [5, 6, 7, 0, 0] and np_.dtype == np.int32
    assert pad_items(3, q4, q4, m, m)[0] is q4


def test_cuda_wrapper_rejects_unsupported_band():
    """The kernel wrapper checks the band before touching nvcc or the
    card, so an unsupported tier fails with a clear error everywhere."""
    from raconx.ops import cuda_kernels

    q = np.zeros((2, 128), np.int8)
    with pytest.raises(ValueError, match="band 96"):
        cuda_kernels.nw_band(q, q, np.zeros((2, 129), np.int32), w_band=96,
                             match=1, mismatch=-1, gap=-1)
    with pytest.raises(ValueError, match="band 96"):
        cuda_kernels.myers_sweep(q, q, w_band=96)


def test_cuda_build_command_targets_hopper():
    import jax
    from raconx.ops import cuda_kernels

    cmd = cuda_kernels.build_command("out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert jax.ffi.include_dir() in cmd
    assert cmd[-1].endswith("kernels.cu")


# ---------------------------------------------------------------------- #
# on the card: the CUDA kernel vs the jnp reference, equal bit for bit
# ---------------------------------------------------------------------- #


@pytest.mark.gpu
@pytest.mark.parametrize("cap,w", [(256, 128), (640, 128), (1280, 512),
                                   (2560, 768), (10240, 2048)])
def test_cuda_sweep_matches_ref(gpu, cap, w):
    from raconx.ops import cuda_kernels

    rng = np.random.default_rng(cap + w)
    pairs = _pairs(rng, 37, cap // 2, cap - 8, cap // 20)
    q, t, gc, _ = _inputs(pairs, -8, cap)
    kw = dict(match=5, mismatch=-4, gap=-8)
    mv_k, sc_k = cuda_kernels.nw_band(q, t, gc, w_band=w, **kw)
    mv_r, sc_r = nw_band_batch_ref(q, t, gc, m_cap=cap, n_cap=cap, w_band=w,
                                   **kw)
    np.testing.assert_array_equal(np.asarray(sc_k), np.asarray(sc_r))
    np.testing.assert_array_equal(np.asarray(mv_k), np.asarray(mv_r))


@pytest.mark.gpu
@pytest.mark.parametrize("cap,w", [(640, 128), (2560, 768)])
def test_cuda_walk_matches_ref(gpu, cap, w):
    from raconx.ops import cuda_kernels

    rng = np.random.default_rng(cap - w)
    pairs = _pairs(rng, 45, cap // 2, cap - 8, cap // 20)
    # one band escape: a query far shorter than its target
    pairs.append((pairs[0][1][: cap // 8].copy(), pairs[0][1]))
    q, t, gc, _ = _inputs(pairs, -8, cap)
    m = np.array([len(a) for a, _ in pairs], np.int32)
    n = np.array([len(b) for _, b in pairs], np.int32)
    moves, _ = nw_band_batch_ref(q, t, gc, m_cap=cap, n_cap=cap, w_band=w,
                                 match=5, mismatch=-4, gap=-8)
    steps = walk_steps(cap, cap, w)
    codes, esc = walk_moves_device(moves, m, n, m_cap=cap, n_cap=cap,
                                   w_band=w, max_steps=steps, packed=True)
    got = cuda_kernels.nw_walk(moves, m, n, m_cap=cap, n_cap=cap, w_band=w,
                               max_steps=steps)
    want = np.concatenate([np.asarray(codes), np.asarray(esc)[:, None]], 1)
    assert want[-1, -1] == 1
    np.testing.assert_array_equal(np.asarray(got), want)
