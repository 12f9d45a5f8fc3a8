"""Multi-device scale-out: the sharded fused dispatch vs one device.

Runs on the virtual 8-device CPU mesh from conftest. Validates (a) that the
sharded align+walk produces the same payloads as the unsharded path, with
every shard's inputs placed on its own device, and (b) the driver-facing
__graft_entry__ hooks.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from raconx.ops.nw_kernel import (  # noqa: E402
    align_walk_batch, align_walk_core, encode, pack_codes4, pack_delbits,
    walk_steps, PAD_CODE)


M_CAP = N_CAP = 128
W = 64
SCORES = dict(match=5, mismatch=-4, gap=-8)
ACGT = np.frombuffer(b"ACGT", np.uint8)


def _batch(B, seed=7):
    rng = np.random.default_rng(seed)
    q = np.full((B, M_CAP), PAD_CODE, np.int32)
    t = np.full((B, N_CAP), PAD_CODE, np.int32)
    gc = np.zeros((B, N_CAP + 1), np.int32)
    m = np.zeros(B, np.int32)
    n = np.zeros(B, np.int32)
    for b in range(B):
        nlen = int(rng.integers(40, N_CAP))
        mlen = int(rng.integers(max(1, nlen - 20), min(M_CAP, nlen + 20)))
        tb = rng.choice(ACGT, nlen)
        qb = rng.choice(ACGT, mlen)
        k = min(mlen, nlen)
        qb[:k] = tb[:k]
        for pos in rng.choice(mlen, mlen // 10, replace=False):
            qb[pos] = rng.choice(ACGT)
        q[b, :mlen] = encode(qb)
        t[b, :nlen] = encode(tb)
        gc[b, 1:] = np.cumsum(np.full(N_CAP, SCORES["gap"], np.int32))
        m[b], n[b] = mlen, nlen
    return q, t, gc, m, n


def test_sharded_step_matches_unsharded():
    from raconx.parallel.mesh import sharded_align_walk, window_mesh

    devs = jax.devices("cpu")
    n_dev = min(8, len(devs))
    mesh = window_mesh(devs[:n_dev])
    B = 16 * n_dev
    q, t, gc, m, n = _batch(B)
    dc8 = np.full(q.shape, SCORES["gap"], np.int8)
    args = (pack_codes4(q.astype(np.int8)), pack_codes4(t.astype(np.int8)),
            pack_delbits(dc8), m, n)
    kw = dict(m_cap=M_CAP, n_cap=N_CAP, w_band=W, kernel=False, **SCORES)
    pay_s, score_s = sharded_align_walk(mesh, align_walk_core, args, **kw)
    # each device holds its own slice of the batch (no staging on one)
    shards = pay_s.addressable_shards
    assert len({sh.device for sh in shards}) == n_dev
    assert all(sh.data.shape[0] == B // n_dev for sh in shards)
    pay_u, score_u = align_walk_batch(*args, **kw)
    pay_s, pay_u = jax.device_get((pay_s, pay_u))
    assert (np.asarray(score_s) == np.asarray(score_u)).all()
    assert (pay_s == pay_u).all()
    assert not pay_u[:, -1].any()
    # op streams consume exactly the real characters of each item
    codes = np.unpackbits(pay_u[:, :-1, None], axis=2, bitorder="little")
    codes = codes.reshape(B, -1, 2)
    steps = codes[..., 0] + 2 * codes[..., 1]
    assert steps.shape[1] == walk_steps(M_CAP, N_CAP, W)
    for b in range(0, B, 17):
        c = steps[b]
        assert ((c == 0) | (c == 1)).sum() == m[b]
        assert ((c == 0) | (c == 2)).sum() == n[b]


def test_graft_entry_hooks():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    g.dryrun_multichip(min(8, len(jax.devices("cpu"))))
