"""Myers bit-parallel banded edit distance: the align stage's sweep + walk.

For the overlap ALIGNMENT stage the scores are fixed at (0, -1, -1) with
uniform deletion costs: pure edit distance, where Myers' bit-parallel
recurrence [Myers 1999; Hyyro 2003 banded variant] computes 32 DP cells
per 32-bit word in ~20 word ops. This plays edlib's role in the reference
(vendor/meson.build:13-19, src/overlap.cpp:205-224).

Layout:
  - band of W target positions per query row, lane k <-> j = i + dlo + k,
    dlo = band_dlo(m_cap, n_cap, W) <= 0; W bits pack into nw = W/32
    int32 words.
  - state between rows: PV/MV horizontal-delta bit vectors
    (D(i, j_k) - D(i, j_k - 1) == +1 / -1) in the CURRENT row's band
    coordinates; the band shift is a 1-bit funnel shift toward lower
    bits per row, top bit filled with PV=1/MV=0 (the soft band edge: a
    monotone +1 ramp that hard-edge DP values provably never prefer).
  - the j = 0 boundary column rides bit kz = -(i + dlo): its vertical
    delta is forced to +1 (D(i,0) = i) and all bits below kz are
    sanitized to zero so the add's carry chain enters the valid region
    with carry-in 0 — bit-exact hard-boundary semantics.
  - per row the sweep stores two W-bit planes: DIAG = Eq | ~D0
    (move 0 valid: D(i,j) == D(i-1,j-1) + [q_i != t_j]) and UP = HP
    (move 1 valid: D(i,j) == D(i-1,j) + 1). With the DIAG > UP > LEFT
    priority these reproduce the scored sweep's move choices for
    (0,-1,-1) with uniform deletion costs, so decoded op lists (and
    breaking points) match the scored path exactly. Planes layout:
    (B, m_cap, 2, nw) int32.

The walk consumes the planes word-wise — nearest non-LEFT bit at-or-below
the current lane via masked highest-set-bit — and emits one record byte per
query row (REC_DIAG/REC_UP | deletions<<2), then the final-deletions byte
and the escape flag; the native decoder bindings.opstream_rows_to_ops_batch
turns that into op lists. Sweep and walk each exist twice, bit-identical:
plain jax.numpy (myers_sweep_ref, myers_walk_ref; any platform) and CUDA
(cuda_kernels.myers_sweep / myers_walk, one warp per item).

Scores are not produced (the align stage discards them); the score
output is zeros.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .nw_kernel import band_dlo, pad_items, unpack_codes4

NW_CODES = 6  # ACGTN + PAD
REC_DIAG = 1
REC_UP = 2


def rows_payload_width(m_cap: int) -> int:
    """Payload bytes per item: one record per query row + the
    final-deletions byte + the escape flag."""
    return m_cap + 2


def guard_bits(w_band: int) -> int:
    """Zero-bit guard on each side of the Peq bitmask so every row's
    W-bit window load is in range (multiple of 32)."""
    return w_band // 2 + 32


def peq_words(n_cap: int, w_band: int) -> int:
    return (n_cap + 2 * guard_bits(w_band)) // 32


def build_peq(t8, n_cap: int, w_band: int):
    """(B, n_cap) target codes -> (NW_CODES, peq_words, B) int32 bit
    planes: plane c bit p (word p>>5, bit p&31) = [t[p - guard] == c],
    with guard_bits(w_band) zero bits below and above."""
    B = t8.shape[0]
    g = guard_bits(w_band)
    codes = jnp.arange(NW_CODES, dtype=jnp.int32)
    bits = (t8.T.astype(jnp.int32)[None] == codes[:, None, None])
    weights = (jnp.int32(1) << (jnp.arange(32, dtype=jnp.int32)))
    packed = jnp.sum(
        bits.reshape(NW_CODES, n_cap // 32, 32, B)
        * weights[None, None, :, None], axis=2, dtype=jnp.int32)
    pad = jnp.zeros((NW_CODES, g // 32, B), jnp.int32)
    return jnp.concatenate([pad, packed, pad], axis=1)


# ------------------------- word-vector helpers ------------------------- #
# arrays are (nw, B) int32; bit index b = 32*w + (b & 31), low-to-high.


def _lsr(x, s):
    """Logical shift right on int32 (s: python int, traced scalar, or
    matching array)."""
    s = jnp.broadcast_to(jnp.asarray(s, x.dtype), x.shape)
    return jax.lax.shift_right_logical(x, s)


def _mask_ge(pos, nw: int, B: int):
    """Bits >= pos set (pos may be a traced scalar; pos <= 0 -> all)."""
    w32 = 32 * jax.lax.broadcasted_iota(jnp.int32, (nw, B), 0)
    sh = jnp.clip(pos - w32, 0, 32)
    full = jnp.int32(-1)
    return jnp.where(sh >= 32, 0, full << jnp.minimum(sh, 31))


def _mask_le(pos, nw: int, B: int):
    """Bits <= pos set; pos is (1, B) per-item. pos < 0 -> none,
    pos >= 32*nw - 1 -> all."""
    w32 = 32 * jax.lax.broadcasted_iota(jnp.int32, (nw, B), 0)
    sh = jnp.clip(pos - w32 + 1, 0, 32)  # number of low bits set per word
    ones = jnp.int32(-1)
    partial = ~(ones << jnp.clip(sh, 0, 31))  # sh in [0,31]: low sh bits
    return jnp.where(sh >= 32, ones, partial)


def _onehot(pos, nw: int, B: int):
    """Single bit at pos (scalar or (1,B)); out-of-range -> zeros."""
    w32 = 32 * jax.lax.broadcasted_iota(jnp.int32, (nw, B), 0)
    rel = pos - w32
    inw = (rel >= 0) & (rel < 32)
    return jnp.where(inw, jnp.int32(1) << (rel & 31), 0)


def _carry_out(x, y, s):
    """Bit 31 carry of the per-word add s = x + y, as 0/1 int32."""
    return _lsr((x & y) | ((x | y) & ~s), 31)


def _words_up(a, n=1):
    """Shift n words toward HIGHER word index (word w reads word w-n; the
    low n words read 0)."""
    return jnp.concatenate([jnp.zeros_like(a[:n]), a[:-n]], axis=0)


def _words_down(a):
    """Shift one word toward LOWER word index (the top word reads 0)."""
    return jnp.concatenate([a[1:], jnp.zeros_like(a[:1])], axis=0)


def _add_carry(x, y):
    """Multi-word add x + y with cross-word carry propagation."""
    s0 = x + y
    g = _carry_out(x, y, s0)
    p = (s0 == -1)
    # ripple the carry chain: cin[w] = g[w-1] | (p[w-1] & cin[w-1]).
    # nw is small (4..128); the prefix runs in log2(nw) doubling steps on
    # (nw, B) arrays: after step k, acc[w] = carry generated within the
    # last 2^k words and propagated across them.
    gacc = _words_up(g)
    pacc = _words_up(p.astype(jnp.int32))
    nw = x.shape[0]
    step = 1
    while step < nw:
        gacc = gacc | (pacc & _words_up(gacc, step))
        pacc = pacc & _words_up(pacc, step)
        step *= 2
    cin = gacc
    return s0 + cin


def _shl1(x):
    """Whole-register shift toward higher bits by 1 (carry across words);
    bit 0 filled with 0."""
    prev = _words_up(x)
    return (x << 1) | (_lsr(prev, 31) & 1)


def _shr1(x, fill_bit):
    """Whole-register shift toward lower bits by 1; top bit (bit
    32*nw - 1) filled with fill_bit (0/1)."""
    nxt = _words_down(x)
    nw = x.shape[0]
    widx = jax.lax.broadcasted_iota(jnp.int32, x.shape, 0)
    top_fill = jnp.where(widx == nw - 1, jnp.int32(fill_bit) << 31, 0)
    hi = jnp.where(widx == nw - 1, top_fill, nxt << 31)
    return (_lsr(x, 1) & 0x7FFFFFFF) | hi


def _hibit(x):
    """Highest set bit index of each int32 (0..31); x == 0 -> 0.
    Branch-free binary search on the logical value."""
    r = jnp.zeros_like(x)
    v = x
    for sh, thr in ((16, jnp.int32(0xFFFF)), (8, jnp.int32(0xFF)),
                    (4, jnp.int32(0xF)), (2, jnp.int32(0x3)),
                    (1, jnp.int32(0x1))):
        big = _lsr(v, sh) != 0
        r = r + jnp.where(big, sh, 0)
        v = jnp.where(big, _lsr(v, sh), v)
    return r


def _myers_row_step(eq, PV, MV, kz):
    """One Myers row on sanitized word vectors (nw, B). Returns
    (diag_plane, up_plane, PVn, MVn) in THIS row's band coordinates
    (callers band-shift + sanitize for the next row)."""
    nw, B = eq.shape
    X = eq | MV
    XP = X & PV
    S = _add_carry(XP, PV)
    D0 = (S ^ PV) | X
    HN = PV & D0
    HP = MV | ~(PV | D0)
    oh = _onehot(kz, nw, B)  # j = 0 boundary column: vertical delta +1
    HP = HP | oh
    HN = HN & ~oh
    X2 = _shl1(HP)
    PVn = _shl1(HN) | ~(D0 | X2)
    MVn = D0 & X2
    return eq | ~D0, HP, PVn, MVn


def _sanitize(PV, MV, eq, kz, nw: int, B: int):
    """Zero every bit at or below the j = 0 boundary lane so the add's
    carry chain enters the valid region with carry-in 0."""
    keep = _mask_ge(kz + 1, nw, B)
    return PV & keep, MV & keep, eq & keep


# --------------------------- jnp reference ---------------------------- #


def _funnel_window(peq, pos0, nw: int):
    """Extract nw words = bits [pos0, pos0 + 32*nw) from the (nwp, B)
    plane `peq` (pos0 traced scalar, guaranteed >= 0 and in range)."""
    w0 = pos0 >> 5
    r = pos0 & 31
    lo = jax.lax.dynamic_slice_in_dim(peq, w0, nw, axis=0)
    hi = jax.lax.dynamic_slice_in_dim(peq, w0 + 1, nw, axis=0)
    return jnp.where(r == 0, lo, _lsr(lo, r) | (hi << ((32 - r) & 31)))


@functools.partial(jax.jit, static_argnames=("m_cap", "n_cap", "w_band"))
def myers_sweep_ref(q8, t8, *, m_cap, n_cap, w_band):
    """q8 (B, m_cap) / t8 (B, n_cap) codes. Returns planes
    (B, m_cap, 2, nw) int32: [:, row-1, 0] = DIAG words, [:, row-1, 1] =
    UP words, in row coordinates."""
    W = w_band
    nw = W // 32
    B = q8.shape[0]
    dlo = band_dlo(m_cap, n_cap, W)
    g = guard_bits(W)
    peq = build_peq(t8, n_cap, W)
    qT = q8.T.astype(jnp.int32)

    pv0 = _mask_ge(-(1 + dlo) + 1, nw, B)
    mv0 = jnp.zeros((nw, B), jnp.int32)

    def row(carry, i):
        PV, MV = carry
        kz = -(i + dlo)
        # Eq: W-bit windows of all 6 planes at p = i + dlo - 1 + guard,
        # selected by this row's per-item query code
        pos0 = i + dlo - 1 + g
        qi = qT[i - 1][None, :]  # (1, B)
        eq = jnp.zeros((nw, B), jnp.int32)
        for c in range(NW_CODES):
            win = _funnel_window(peq[c], pos0, nw)
            eq = eq | jnp.where(qi == c, win, 0)
        PV, MV, eq = _sanitize(PV, MV, eq, kz, nw, B)
        diag, HP, PVn, MVn = _myers_row_step(eq, PV, MV, kz)
        planes = jnp.stack([diag, HP], axis=0)  # (2, nw, B)
        PV2 = _shr1(PVn, 1)
        MV2 = _shr1(MVn, 0)
        return (PV2, MV2), planes

    _, planes = jax.lax.scan(row, (pv0, mv0),
                             jnp.arange(1, m_cap + 1, dtype=jnp.int32))
    return planes.transpose(3, 0, 1, 2)


def myers_walk_ref(planes, m, n, *, m_cap, n_cap, w_band):
    """planes (B, m_cap, 2, nw) from either sweep; m/n (B,) int32.
    Returns (payload (B, m_cap + 2) uint8, escaped (B,) bool)."""
    W = w_band
    nw = W // 32
    B = planes.shape[0]
    dlo = band_dlo(m_cap, n_cap, W)
    m2 = m.reshape(1, B).astype(jnp.int32)
    n2 = n.reshape(1, B).astype(jnp.int32)

    def row(carry, i):
        kvec, esc = carry  # (1, B) int32
        kz = -(i + dlo)
        words = jax.lax.dynamic_index_in_dim(planes, i - 1, axis=1,
                                             keepdims=False)  # (B, 2, nw)
        oh = _onehot(kz, nw, B)
        diag = words[:, 0].T & ~oh
        up = words[:, 1].T | oh
        rec, kvec, esc = _walk_row_words(diag, up, kvec, esc,
                                         (i <= m2).astype(jnp.int32), nw, B)
        return (kvec, esc), rec[0]

    init = (n2 - m2 - dlo, jnp.zeros((1, B), jnp.int32))
    (kvec, esc), recs = jax.lax.scan(row, init,
                                     jnp.arange(m_cap, 0, -1,
                                                dtype=jnp.int32))
    recs = recs[::-1]
    jfin = dlo + kvec
    esc = esc | ((jfin < 0) | (jfin > 255)).astype(jnp.int32)
    payload = jnp.concatenate(
        [recs.T.astype(jnp.uint8),
         jnp.clip(jfin, 0, 255).T.astype(jnp.uint8),
         esc.T.astype(jnp.uint8)], axis=1)
    return payload, esc[0].astype(bool)


def _walk_row_words(diag, up, kvec, esc, active, nw: int, B: int):
    """One backward row step on word planes (nw, B). kvec/esc/active are
    (1, B) int32. Mirrors nw_kernel._walk_rows_row's semantics exactly:
    exit at the highest non-LEFT lane <= kvec, DIAG priority over UP,
    escape on no exit / out-of-band kvec / >63 deletions."""
    notleft = diag | up
    inband = (kvec >= 0) & (kvec < 32 * nw)
    masked = notleft & _mask_le(kvec, nw, B)
    nzw = masked != 0
    hib = _hibit(masked)
    w32 = 32 * jax.lax.broadcasted_iota(jnp.int32, (nw, B), 0)
    cand = jnp.where(nzw, w32 + hib, -1)
    k_exit = jnp.max(cand, axis=0, keepdims=True)  # (1, B)
    ohx = _onehot(k_exit, nw, B)
    # single-bit selects: sum over words isolates the one hit word (the
    # bit may be bit 31, so nonzero-test rather than max)
    diag_hit = jnp.sum(diag & ohx, axis=0, keepdims=True) != 0
    up_hit = jnp.sum(up & ohx, axis=0, keepdims=True) != 0
    nleft = kvec - k_exit
    bad = (~inband) | (k_exit < 0) | (nleft > 63)
    esc = esc | (active * bad.astype(jnp.int32))
    act2 = active * (1 - esc)
    op = jnp.where(diag_hit, REC_DIAG, REC_UP)
    rec = jnp.where(act2 != 0, op | (nleft << 2), 0)
    kvec = jnp.where(act2 != 0,
                     k_exit + (up_hit & ~diag_hit).astype(jnp.int32), kvec)
    return rec, kvec, esc


def align_walk_myers_core(q4, t4, m, n, *, m_cap, n_cap, w_band, kernel):
    """Fused Myers align+walk for the (0,-1,-1) align stage: q4/t4
    (B, CAP//2) uint8 nibble-packed codes (pack_codes4 layout), m/n (B,)
    int32 real lengths. Returns (payload (B, m_cap + 2) uint8 incl. the
    escape column, score zeros (B, 1) — the align stage discards scores,
    reference src/overlap.cpp:205-224 only consumes the CIGAR)."""
    q8 = unpack_codes4(q4, m_cap)
    t8 = unpack_codes4(t4, n_cap)
    if kernel:
        from . import cuda_kernels

        planes = cuda_kernels.myers_sweep(q8, t8, w_band=w_band)
        payload = cuda_kernels.myers_walk(planes, m, n, n_cap=n_cap)
    else:
        planes = myers_sweep_ref(q8, t8, m_cap=m_cap, n_cap=n_cap,
                                 w_band=w_band)
        payload, _ = myers_walk_ref(planes, m, n, m_cap=m_cap, n_cap=n_cap,
                                    w_band=w_band)
    return payload, jnp.zeros((q4.shape[0], 1), jnp.int32)


align_walk_myers_batch = jax.jit(
    align_walk_myers_core,
    static_argnames=("m_cap", "n_cap", "w_band", "kernel"))


def align_walk_myers_padded(q4, t4, m, n, *, m_cap, n_cap, w_band, kernel,
                            fixed_b=None):
    """Pads the packed batch to the canonical size with all-PAD items and
    dispatches the fused Myers align+walk, sharded over the active mesh
    when one exists (parallel/mesh.py). Returns (payload, score) for the
    padded batch."""
    from .nw_kernel import padded_batch
    from ..parallel.mesh import active_mesh, sharded_align_walk

    mesh = active_mesh()
    bp = padded_batch(q4.shape[0], fixed_b,
                      mesh.devices.size if mesh is not None else 1)
    q4, t4, m, n = pad_items(bp, q4, t4, m, n)
    kw = dict(m_cap=m_cap, n_cap=n_cap, w_band=w_band, kernel=kernel)
    if mesh is not None:
        return sharded_align_walk(mesh, align_walk_myers_core,
                                  (q4, t4, m, n), **kw)
    return align_walk_myers_batch(q4, t4, m, n, **kw)
