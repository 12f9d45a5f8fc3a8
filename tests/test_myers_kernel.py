"""Myers bit-parallel align sweep + walk vs the scored banded-NW path.

For (0, -1, -1) scores with uniform deletion costs the Myers sweep+walk
must decode to op lists BIT-IDENTICAL to the scored fused path (same band
geometry, same DIAG > UP > LEFT move priority), including escape behavior
on band exits and >63-deletion rows, and to the native C++ aligner's. On
CPU the sweep is myers_sweep_ref; the `gpu`-marked test compares the CUDA
kernel with it on the card at the align tiers' real widths."""

import numpy as np
import pytest

from raconx.native import loader

if not loader.available():
    pytest.skip("native runtime unavailable", allow_module_level=True)

from raconx.native import bindings
from raconx.ops.myers_kernel import align_walk_myers_batch
from raconx.ops.nw_kernel import (align_walk_batch, encode, pack_codes4,
                                  pack_delbits, walk_steps, PAD_CODE)

ACGT = np.frombuffer(b"ACGT", np.uint8)


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


def _panels(pairs, m_cap, n_cap):
    B = len(pairs)
    q8 = np.full((B, m_cap), PAD_CODE, np.int8)
    t8 = np.full((B, n_cap), PAD_CODE, np.int8)
    m = np.zeros(B, np.int32)
    n = np.zeros(B, np.int32)
    for b, (qa, ta) in enumerate(pairs):
        q8[b, : len(qa)] = encode(qa)
        t8[b, : len(ta)] = encode(ta)
        m[b], n[b] = len(qa), len(ta)
    return q8, t8, m, n


def _decode_rows(payload, m, n):
    payload = np.asarray(payload)
    esc = payload[:, -1] != 0
    ops, off, cnt = bindings.opstream_rows_to_ops_batch(
        payload, payload.shape[1], m, n, 2)
    return ops, off, cnt, esc


def _decode_packed2(q8, t8, m, n, m_cap, n_cap, w):
    dc8 = np.full((len(m), n_cap), -1, np.int8)
    payload, score = align_walk_batch(
        pack_codes4(q8), pack_codes4(t8), pack_delbits(dc8), m, n,
        m_cap=m_cap, n_cap=n_cap, w_band=w, match=0, mismatch=-1, gap=-1,
        kernel=False)
    payload = np.asarray(payload)
    esc = payload[:, -1] != 0
    codes = np.ascontiguousarray(payload[:, :-1])
    ops, off, cnt = bindings.opstream_packed_to_ops_batch(
        codes, walk_steps(m_cap, n_cap, w), m, n, 2)
    return ops, off, cnt, esc


def _myers_ops(q8, t8, m, n, m_cap, n_cap, w):
    payload, _ = align_walk_myers_batch(
        pack_codes4(q8), pack_codes4(t8), m, n, m_cap=m_cap, n_cap=n_cap,
        w_band=w, kernel=False)
    return _decode_rows(payload, m, n)


def _assert_identical(pairs, m_cap, n_cap, w, allow_escape=False):
    q8, t8, m, n = _panels(pairs, m_cap, n_cap)
    o1, f1, c1, e1 = _decode_packed2(q8, t8, m, n, m_cap, n_cap, w)
    o2, f2, c2, e2 = _myers_ops(q8, t8, m, n, m_cap, n_cap, w)
    for b in range(len(pairs)):
        assert e1[b] == e2[b], f"item {b}: escape {e1[b]} vs {e2[b]}"
        if e1[b]:
            assert allow_escape, f"item {b}: unexpected escape"
            continue
        a = o1[f1[b] : f1[b] + c1[b]]
        c = o2[f2[b] : f2[b] + c2[b]]
        assert np.array_equal(a, c), f"item {b}:\n{a}\nvs\n{c}"


@pytest.mark.parametrize("w", [64, 128])
def test_random_mutations_match(w):
    rng = np.random.default_rng(51)
    pairs = []
    for _ in range(64):
        tlen = int(rng.integers(8, 128))
        t = rng.choice(ACGT, tlen)
        q = _mutate(rng, t, int(rng.integers(0, tlen // 3 + 1)))[:128]
        pairs.append((q, t))
    _assert_identical(pairs, 128, 128, w)


def test_heavy_drift_near_band_margin():
    """Length mismatch close to the band edge: paths hug the band, the
    soft-edge fills must not change any in-band move."""
    rng = np.random.default_rng(53)
    pairs = []
    for _ in range(48):
        tlen = int(rng.integers(80, 128))
        t = rng.choice(ACGT, tlen)
        q = t.copy()
        drop = int(rng.integers(0, 28))  # up to band/2 - 4 drift at W=64
        if drop:
            q = np.delete(q, rng.choice(len(q), min(drop, len(q) - 2),
                                        replace=False))
        pairs.append((q, t))
    _assert_identical(pairs, 128, 128, 64, allow_escape=True)


def test_long_insert_runs_and_escapes():
    rng = np.random.default_rng(57)
    pairs = []
    for _ in range(24):
        tlen = int(rng.integers(70, 120))
        t = rng.choice(ACGT, tlen)
        q = t.copy()
        ins = rng.choice(ACGT, int(rng.integers(0, 30)))
        pos = int(rng.integers(0, len(q)))
        q = np.insert(q, pos, ins)[:128]
        pairs.append((q, t))
    # query prefix: a >63-deletion tail must escape in BOTH paths the
    # same way (rows-format 6-bit deletion-count limit)
    t = rng.choice(ACGT, 120)
    pairs.append((t[:20].copy(), t))
    _assert_identical(pairs, 128, 128, 64, allow_escape=True)


def test_mixed_identical_and_empty():
    rng = np.random.default_rng(59)
    t = rng.choice(ACGT, 100)
    pairs = [(t.copy(), t),               # all-diagonal
             (t[:60].copy(), t[:60]),
             (rng.choice(ACGT, 1), rng.choice(ACGT, 1))]
    _assert_identical(pairs, 128, 128, 64)


def test_unequal_caps_rejected_only_when_dlo_positive():
    """The Myers path requires dlo <= 0 (the band starts at or left of
    column 0); equal caps (the align stage contract) always qualify."""
    from raconx.ops.nw_kernel import band_dlo

    assert band_dlo(128, 128, 64) <= 0


def test_mesh_sharded_myers_matches_single():
    """The Myers core sharded over the 8-device CPU mesh must produce the
    same payload bytes as the single-device dispatch."""
    import jax

    from raconx.ops.myers_kernel import align_walk_myers_core
    from raconx.parallel.mesh import sharded_align_walk, window_mesh

    devs = jax.devices("cpu")
    if len(devs) < 8:
        pytest.skip("needs 8 virtual CPU devices")
    mesh = window_mesh(devs[:8])
    rng = np.random.default_rng(67)
    pairs = []
    for _ in range(64):
        tlen = int(rng.integers(16, 128))
        t = rng.choice(ACGT, tlen)
        q = _mutate(rng, t, int(rng.integers(0, tlen // 4 + 1)))[:128]
        pairs.append((q, t))
    q8, t8, m, n = _panels(pairs, 128, 128)
    q4, t4 = pack_codes4(q8), pack_codes4(t8)
    kw = dict(m_cap=128, n_cap=128, w_band=64, kernel=False)
    payload, _ = sharded_align_walk(mesh, align_walk_myers_core,
                                    (q4, t4, m, n), **kw)
    assert payload.sharding.mesh.devices.size == 8
    p_ref, _ = align_walk_myers_batch(q4, t4, m, n, **kw)
    assert np.array_equal(np.asarray(payload), np.asarray(p_ref))


@pytest.mark.parametrize("w", [64, 128, 256])
@pytest.mark.parametrize("rate", [0.02, 0.12, 0.25])
def test_myers_matches_native_aligner(w, rate):
    """Device-path op lists equal the native edit-distance aligner's (the
    native align stage) whenever the device walk does not escape."""
    rng = np.random.default_rng(int(rate * 100) + w)
    cap = 256
    pairs = []
    for _ in range(24):
        tlen = int(rng.integers(cap // 2, cap - 16))
        t = rng.choice(ACGT, tlen)
        pairs.append((_mutate(rng, t, int(tlen * rate))[:cap], t))
    q8, t8, m, n = _panels(pairs, cap, cap)
    ops, off, cnt, esc = _myers_ops(q8, t8, m, n, cap, cap, w)
    qoff = np.concatenate([[0], np.cumsum(m)]).astype(np.int64)
    toff = np.concatenate([[0], np.cumsum(n)]).astype(np.int64)
    hops, hoff, hcnt = bindings.align_batch(
        np.concatenate([a for a, _ in pairs]), qoff,
        np.concatenate([b for _, b in pairs]), toff, 0, -1, -1, True, 2)
    checked = 0
    for b in range(len(pairs)):
        if esc[b]:
            continue
        assert np.array_equal(ops[off[b] : off[b] + cnt[b]],
                              hops[hoff[b] : hoff[b] + hcnt[b]]), b
        checked += 1
    assert checked >= len(pairs) // 2


def test_myers_sweep_planes_layout():
    """Planes are (B, m_cap, 2, W/32): the layout the CUDA kernel writes
    (one warp per item, one row of DIAG then UP words at a time)."""
    from raconx.ops.myers_kernel import myers_sweep_ref

    q8 = np.full((3, 128), PAD_CODE, np.int8)
    planes = myers_sweep_ref(q8, q8, m_cap=128, n_cap=128, w_band=128)
    assert planes.shape == (3, 128, 2, 4) and planes.dtype == np.int32


@pytest.mark.gpu
@pytest.mark.parametrize("cap,w", [(2560, 512), (10240, 1024),
                                   (10240, 4096)])
def test_cuda_myers_matches_ref(gpu, cap, w):
    from raconx.ops import cuda_kernels
    from raconx.ops.myers_kernel import myers_sweep_ref

    rng = np.random.default_rng(cap + w)
    pairs = []
    for _ in range(19):
        tlen = int(rng.integers(cap // 2, cap - 64))
        t = rng.choice(ACGT, tlen)
        pairs.append((_mutate(rng, t, int(tlen * 0.12))[:cap], t))
    q8, t8, _, _ = _panels(pairs, cap, cap)
    got = cuda_kernels.myers_sweep(q8, t8, w_band=w)
    want = myers_sweep_ref(q8, t8, m_cap=cap, n_cap=cap, w_band=w)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.gpu
@pytest.mark.parametrize("cap,w", [(2560, 512), (10240, 1024),
                                   (10240, 4096)])
def test_cuda_myers_walk_matches_ref(gpu, cap, w):
    from raconx.ops import cuda_kernels
    from raconx.ops.myers_kernel import myers_sweep_ref, myers_walk_ref

    rng = np.random.default_rng(cap - w)
    pairs = []
    for _ in range(23):
        tlen = int(rng.integers(cap // 2, cap - 64))
        t = rng.choice(ACGT, tlen)
        pairs.append((_mutate(rng, t, int(tlen * 0.12))[:cap], t))
    pairs.append((pairs[0][1][:40].copy(), pairs[0][1]))  # must escape
    q8, t8, m, n = _panels(pairs, cap, cap)
    planes = myers_sweep_ref(q8, t8, m_cap=cap, n_cap=cap, w_band=w)
    want, esc = myers_walk_ref(planes, m, n, m_cap=cap, n_cap=cap, w_band=w)
    assert bool(np.asarray(esc)[-1])
    got = cuda_kernels.myers_walk(planes, m, n, n_cap=cap)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
