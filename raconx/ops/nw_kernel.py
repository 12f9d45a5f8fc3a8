"""Batched banded linear-gap NW: the consensus stage's alignment core.

This plays the role of spoa's SIMD sequence-vs-graph DP (SURVEY.md sec
3.2) as layer-vs-backbone alignment inside the star-POA consensus
(ops/poa_host.py, native/src/poa.cpp).

Design:
  - items are padded to equal caps (m_cap == n_cap) with a pad code that
    matches itself and hard-rejects real bases, so every item shares ONE
    static band geometry (diagonal band of width W centered on the corner
    diagonal). The real alignment's DP values are untouched by padding and
    the pad tail resolves to a deterministic diagonal + corner gap run that
    the walk never reaches (it starts at the real corner (m, n)).
  - rows iterate over the query; the in-row horizontal dependency (deletions,
    incl. per-column costs for the refinement passes' optional columns) is
    closed with a max-plus prefix scan over cumulative costs Gc:
    H[i,k] = Gc[j(k)] + running_max_k(cand[i,k] - Gc[j(k)]).
  - traceback moves (2 bits, DIAG>UP>LEFT priority) are packed 16 query
    rows per int32 word, layout (B, m_cap/16, W); walk_moves_device turns
    them into compact per-step op streams on the device.

Two implementations give bit-identical results: the plain jax.numpy sweep
and walk (nw_band_batch_ref, walk_moves_device; any platform) and the CUDA
kernels (cuda_kernels.nw_band, one warp per item with the band in
registers, and cuda_kernels.nw_walk, one thread per item).

Codes: 0..4 real (ACGTN), PAD_CODE = 5.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

PAD_CODE = 5
NEG = -(10 ** 5)  # forbids pad-vs-real pairing; far below any real score

# base-code tables shared with host packers
_CODE = np.full(256, 4, dtype=np.uint8)  # anything unusual -> N
for i, b in enumerate(b"ACGTN"):
    _CODE[b] = i
_DECODE = np.frombuffer(b"ACGTN?", dtype=np.uint8)

_PACK = 16    # query rows packed per int32 move word


def encode(seq: np.ndarray) -> np.ndarray:
    return _CODE[seq]


def band_dlo(m_cap: int, n_cap: int, w_band: int) -> int:
    """j = i + dlo + k for band lane k; shared with the walks."""
    return n_cap - m_cap - w_band // 2


def _shift_right(x, s, fill):
    return jnp.concatenate(
        [jnp.full(x.shape[:-1] + (s,), fill, x.dtype), x[..., :-s]], axis=-1)


def _shift_left(x, s, fill):
    return jnp.concatenate(
        [x[..., s:], jnp.full(x.shape[:-1] + (s,), fill, x.dtype)], axis=-1)


def walk_steps(m_cap: int, n_cap: int, w_band: int) -> int:
    """Static op-stream length of the device walk: long enough for any
    in-band real path with generous indel headroom, 4-aligned for 2-bit
    packing. Paths that would exceed it are flagged escaped and re-aligned
    on the host."""
    return min(_round4(m_cap + 2 * w_band), _round4(m_cap + n_cap))


def _round4(x: int) -> int:
    return -(-x // 4) * 4


# ---- packed uplink: base codes ship 2-per-byte (values 0..5 fit a
# nibble) and the binary {0, gap} per-column deletion costs ship as a
# bitmask; the device unpacks both ----


def pack_codes4(x8: np.ndarray) -> np.ndarray:
    """(B, CAP) int8 codes -> (B, CAP//2) uint8, two codes per byte."""
    x = x8.view(np.uint8)
    return (x[:, 0::2] | (x[:, 1::2] << 4)).astype(np.uint8)


def pack_delbits(dc8: np.ndarray) -> np.ndarray:
    """(B, CAP) deletion costs in {0, gap} -> (B, CAP//8) uint8 bitmask."""
    return np.packbits(np.asarray(dc8) != 0, axis=1, bitorder="little")


def unpack_codes4(q4, cap: int):
    lo = (q4 & 0xF).astype(jnp.int8)
    hi = (q4 >> 4).astype(jnp.int8)
    return jnp.stack([lo, hi], axis=-1).reshape(q4.shape[0], cap)


def unpack_delbits(dcb, cap: int, gap: int):
    bits = (dcb[:, :, None] >> jnp.arange(8, dtype=jnp.uint8)) & 1
    return bits.reshape(dcb.shape[0], cap).astype(jnp.int32) * gap


# ---------------------------------------------------------------------- #
# plain jax.numpy sweep: the reference the CUDA kernel is checked against,
# and the sweep on platforms without it (CPU tests, virtual CPU meshes).
# ---------------------------------------------------------------------- #


@functools.partial(jax.jit, static_argnames=("m_cap", "n_cap", "w_band",
                                             "match", "mismatch", "gap"))
def nw_band_batch_ref(q, t, gc, *, m_cap, n_cap, w_band, match, mismatch,
                      gap):
    """q (B, m_cap) / t (B, n_cap) codes, gc (B, n_cap+1) int32 cumulative
    deletion costs (gc[:, 0] = 0). Returns (moves (B, m_cap//16, W) int32
    packed 2-bit moves, score (B, 1) int32 = H at the padded corner).

    A scan over 16-row groups: each step runs its 16 rows and packs their
    moves into one word per band lane, so no unpacked move stack is
    materialized."""
    assert m_cap % _PACK == 0, "m_cap must be a multiple of 16"
    B = q.shape[0]
    W = w_band
    dlo = band_dlo(m_cap, n_cap, W)
    q = q.astype(jnp.int32)
    tp = jnp.pad(t.astype(jnp.int32), ((0, 0), (W, W)),
                 constant_values=PAD_CODE)
    gcp = jnp.pad(gc.astype(jnp.int32), ((0, 0), (W, 0)))
    gcp = jnp.pad(gcp, ((0, 0), (0, W)), mode="edge")
    kidx = jax.lax.broadcasted_iota(jnp.int32, (B, W), 1)

    j0 = dlo + kidx
    g0 = jax.lax.dynamic_slice(gcp, (0, W + dlo), (B, W))
    h0 = jnp.where((j0 >= 0) & (j0 <= n_cap), g0, NEG)

    def row(hp, i):
        jrow = i + dlo + kidx
        valid = (jrow >= 1) & (jrow <= n_cap)
        start = i - 1 + W + dlo
        t_row = jax.lax.dynamic_slice(tp, (0, start), (B, W))
        gc_here = jax.lax.dynamic_slice(gcp, (0, start + 1), (B, W))
        qi = jax.lax.dynamic_slice(q, (0, i - 1), (B, 1))

        same = t_row == qi
        one_pad = (t_row == PAD_CODE) ^ (qi == PAD_CODE)
        sub = jnp.where(one_pad, NEG, jnp.where(same, match, mismatch))

        diag_c = hp + sub
        up_c = _shift_left(hp, 1, NEG) + gap
        cand = jnp.maximum(diag_c, up_c)
        cand = jnp.where(jrow == 0, i * gap, cand)
        cand = jnp.where(valid | (jrow == 0), cand, NEG)

        a = cand - gc_here
        s = 1
        while s < W:
            a = jnp.maximum(a, _shift_right(a, s, 2 * NEG))
            s *= 2
        h = a + gc_here
        h = jnp.where(valid | (jrow == 0), h, NEG)

        mv = jnp.where(h == diag_c, 0, jnp.where(h == up_c, 1, 2))
        mv = jnp.where(valid, mv, 3)
        return h, mv

    def group(hp, slot):
        def one(u, carry):
            hp, pack = carry
            hp, mv = row(hp, slot * _PACK + u + 1)
            return hp, pack | (mv << (2 * u))

        return jax.lax.fori_loop(0, _PACK, one,
                                 (hp, jnp.zeros((B, W), jnp.int32)))

    h_final, packs = jax.lax.scan(group, h0,
                                  jnp.arange(m_cap // _PACK, dtype=jnp.int32))
    moves = packs.transpose(1, 0, 2)
    k_end = n_cap - m_cap - dlo
    score = jax.lax.dynamic_slice(h_final, (0, k_end), (B, 1))
    return moves, score


# ---------------------------------------------------------------------- #
# on-device traceback walk: keeps the move planes on the device and ships
# only compact per-step op streams to the host (the host C++ run-length-
# encodes them into op lists). Vectorized across the batch with one
# gather per step.
# ---------------------------------------------------------------------- #

OP_STREAM_SKIP = 3  # pad-consuming or finished steps


@functools.partial(jax.jit, static_argnames=("m_cap", "n_cap", "w_band",
                                             "max_steps", "packed"))
def walk_moves_device(moves, m, n, *, m_cap, n_cap, w_band, max_steps,
                      packed=False):
    """moves (B, m_cap//16, W) int32 (device), m/n (B,) int32 real lengths.

    Returns (codes (B, max_steps) int8 emitted BACKWARD from (m, n)
    (0=match, 1=ins, 2=del, 3=skip), escaped (B,) bool band-escape flags).
    With packed=True (max_steps % 4 == 0), codes come back as
    (B, max_steps//4) uint8 with step 4p+u in bits [2u, 2u+2) of byte p.
    The walk starts at each item's REAL corner (m, n) — always in-band
    since |n-m| is bounded by the caller's tier margin — so no cycles are
    spent on the pad tail, and the loop exits as soon as every item
    reaches the origin. Walks that fail to get there within max_steps are
    flagged escaped (host fallback), so a short max_steps is safe."""
    B = moves.shape[0]
    dlo = band_dlo(m_cap, n_cap, w_band)
    mflat = moves.reshape(B, -1)
    m = m.astype(jnp.int32)
    n = n.astype(jnp.int32)

    def step(carry, _):
        i, j, escaped = carry
        k = j - i - dlo
        at_origin = (i == 0) & (j == 0)
        row = jnp.maximum(i - 1, 0)
        widx = (row // _PACK) * w_band + jnp.clip(k, 0, w_band - 1)
        word = jnp.take_along_axis(mflat, widx[:, None], axis=1)[:, 0]
        mv = (word >> (2 * (row % _PACK))) & 3
        mv = jnp.where(i == 0, 2, mv)            # row 0: all deletions
        mv = jnp.where((j == 0) & (i > 0), 1, mv)  # column 0: all insertions
        inband = (k >= 0) & (k < w_band)
        esc = escaped | (~at_origin & (i > 0) & (j > 0) &
                         (~inband | (mv == 3)))
        mv = jnp.where(esc | at_origin, OP_STREAM_SKIP, mv)
        di = jnp.where((mv == 0) | (mv == 1), 1, 0)
        dj = jnp.where((mv == 0) | (mv == 2), 1, 0)
        real = jnp.where(mv == 0, (i <= m) & (j <= n),
                         jnp.where(mv == 1, i <= m, j <= n))
        out = jnp.where((mv == OP_STREAM_SKIP) | ~real, OP_STREAM_SKIP,
                        mv).astype(jnp.int8)
        return (i - di, j - dj, esc), out

    # early-exit while loop: stop as soon as every item is at the origin
    # (or escaped) — typical paths use ~max(m, n) of the max_steps budget
    # and pad items (m = n = 0) finish immediately
    buf0 = jnp.full((max_steps, B), OP_STREAM_SKIP, jnp.int8)

    def cond(carry):
        s, i, j, escaped, _ = carry
        return (s < max_steps) & jnp.any(((i != 0) | (j != 0)) & ~escaped)

    def body(carry):
        s, i, j, escaped, buf = carry
        (i2, j2, esc2), out = step((i, j, escaped), None)
        buf = jax.lax.dynamic_update_slice(buf, out[None, :], (s, 0))
        return (s + 1, i2, j2, esc2, buf)

    init = (jnp.int32(0), m, n, jnp.zeros((B,), bool), buf0)
    _, fi, fj, escaped, outs = jax.lax.while_loop(cond, body, init)
    escaped = escaped | (fi != 0) | (fj != 0)  # truncated walk -> fallback
    if not packed:
        return outs.T, escaped
    assert max_steps % 4 == 0
    quads = outs.astype(jnp.uint8).reshape(max_steps // 4, 4, B)
    shifts = (2 * jnp.arange(4, dtype=jnp.uint8))[None, :, None]
    return jnp.sum(quads << shifts, axis=1, dtype=jnp.uint8).T, escaped


# ---------------------------------------------------------------------- #
# fused dispatch: unpack + sweep + walk in one program per chunk
# ---------------------------------------------------------------------- #


def align_walk_core(q4, t4, dcb, m, n, *, m_cap, n_cap, w_band, match,
                    mismatch, gap, kernel):
    """q4/t4 (B, CAP//2) uint8 nibble-packed codes (pack_codes4), dcb
    (B, CAP//8) uint8 deletion-cost bitmask (pack_delbits; bit set = cost
    `gap`), m/n (B,) int32 real lengths. Returns (payload
    (B, walk_steps(...)//4 + 1) uint8, score (B, 1) int32): payload[:, :-1]
    is the backward op stream packed 4 steps/byte, payload[:, -1] the
    band-escape flag. kernel=True runs the CUDA sweep and walk, else
    their jnp twins."""
    q8 = unpack_codes4(q4, m_cap)
    t8 = unpack_codes4(t4, n_cap)
    dc = unpack_delbits(dcb, n_cap, gap)
    gc = jnp.pad(jnp.cumsum(dc, axis=1), ((0, 0), (1, 0)))
    steps = walk_steps(m_cap, n_cap, w_band)
    if kernel:
        from . import cuda_kernels

        moves, score = cuda_kernels.nw_band(q8, t8, gc, w_band=w_band,
                                            match=match, mismatch=mismatch,
                                            gap=gap)
        return cuda_kernels.nw_walk(moves, m, n, m_cap=m_cap, n_cap=n_cap,
                                    w_band=w_band, max_steps=steps), score
    moves, score = nw_band_batch_ref(q8, t8, gc, m_cap=m_cap, n_cap=n_cap,
                                     w_band=w_band, match=match,
                                     mismatch=mismatch, gap=gap)
    codes, escaped = walk_moves_device(
        moves, m, n, m_cap=m_cap, n_cap=n_cap, w_band=w_band,
        max_steps=steps, packed=True)
    payload = jnp.concatenate([codes, escaped[:, None].astype(jnp.uint8)],
                              axis=1)
    return payload, score


align_walk_batch = jax.jit(
    align_walk_core, static_argnames=("m_cap", "n_cap", "w_band", "match",
                                      "mismatch", "gap", "kernel"))


def padded_batch(B: int, fixed_b, mesh_size: int) -> int:
    """The padded batch dimension a dispatch runs with: fixed_b (callers use
    canonical sizes so each tier compiles few programs) or the next power of
    two (min 16), rounded up so every mesh shard gets an equal slice."""
    if fixed_b is not None:
        bp = max(fixed_b, B)
    else:
        bp = 16
        while bp < B:
            bp *= 2
    return -(-bp // mesh_size) * mesh_size


def pad_items(bp: int, q4, t4, m, n):
    """Pad a packed batch to bp all-PAD (nibbles 0x55), zero-length items."""
    m = np.asarray(m, np.int32)
    n = np.asarray(n, np.int32)
    pad = bp - q4.shape[0]
    if pad == 0:
        return q4, t4, m, n
    rows = ((0, pad), (0, 0))
    return (np.pad(q4, rows, constant_values=0x55),
            np.pad(t4, rows, constant_values=0x55),
            np.pad(m, (0, pad)), np.pad(n, (0, pad)))


def align_walk_padded(q4, t4, dcb, m, n, *, m_cap, n_cap, w_band, match,
                      mismatch, gap, kernel, fixed_b=None):
    """Pads the packed batch to padded_batch(...) items and dispatches the
    fused align+walk, sharded over the device mesh when one is active
    (parallel/mesh.py). Returns (payload, score) for the PADDED batch;
    callers slice [:B]."""
    from ..parallel.mesh import active_mesh, sharded_align_walk

    mesh = active_mesh()
    bp = padded_batch(q4.shape[0], fixed_b,
                      mesh.devices.size if mesh is not None else 1)
    q4, t4, m, n = pad_items(bp, q4, t4, m, n)
    if dcb.shape[0] != bp:
        dcb = np.pad(dcb, ((0, bp - dcb.shape[0]), (0, 0)),
                     constant_values=0xFF)
    kw = dict(m_cap=m_cap, n_cap=n_cap, w_band=w_band, match=match,
              mismatch=mismatch, gap=gap, kernel=kernel)
    if mesh is not None:
        return sharded_align_walk(mesh, align_walk_core, (q4, t4, dcb, m, n),
                                  **kw)
    return align_walk_batch(q4, t4, dcb, m, n, **kw)
