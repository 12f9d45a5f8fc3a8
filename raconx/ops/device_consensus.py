"""Device consensus stage: the device-driver loop of iterative star-POA.

Per refinement pass: all window layers are aligned to their window's current
backbone in batched banded-NW dispatches (ops/nw_kernel.py); the host
C++ runtime decodes the device's op streams and merges them into the
per-window partial-order graphs (native rt_poa_round_batch), producing either
the final consensus or the expanded backbone for the next pass. Items that
exceed the device caps (or escape the band) are realigned on the host thread
pool.

This replaces the reference's spoa window loop (src/polisher.cpp:486-504) and
its CUDA batch path (src/cuda/cudapolisher.cpp:216-353) with fixed-shape
device batches + a host merge, with the same fill/launch/drain overlap role
played by XLA's async dispatch and cohort pipelining.

Host-side layout is columnar: one flat blob per payload (layer codes, layer
raw bytes, weights; per-round backbone/deletion-cost blobs), per-item offset
arrays, and threaded native packing into the dense device matrices
(bindings.pack_rows_nib) — no per-item Python in the hot loop. Device op
streams come back 2-bit packed (nw_kernel.walk_steps).
"""

from __future__ import annotations

import os
import time
from collections import Counter, defaultdict

import numpy as np

from ..utils.phred import PHRED_OFFSET
from . import prefetch
from .nw_kernel import align_walk_padded, encode, walk_steps, PAD_CODE

_MOVES_BUDGET = 1 << 30  # device bytes for one chunk's packed-move planes


def chunk_size(cap: int, band: int, max_items: int) -> int:
    """Alignments per device dispatch: as large as the packed-move budget
    allows, clamped to max_items. Shared by both pipeline stages."""
    per_item = (cap // 16) * band * 4  # int32 move planes
    return max(16, min(max_items, _MOVES_BUDGET // per_item))


def _chunk_size(cap: int, band: int) -> int:
    return chunk_size(cap, band, 8192)


# canonical padded-batch ladder for accelerator dispatches: every chunk is
# padded to the smallest of these that fits (clamped to the tier's step),
# so the compiled-program set per tier is <= 3 regardless of workload
# size, round-over-round retirement, or remainder chunks.
_BP_LADDER = (1024, 4096, 8192)


def chunk_plan(k: int, step: int, ladder: bool):
    """Equalized chunk spans + padded-batch sizes for a tier's k items:
    ceil(k/step) chunks of near-equal size (never a tiny remainder chunk).
    With `ladder` each is assigned the smallest _BP_LADDER size that fits
    and does not exceed step, else step itself (a wide tier's step sits
    between rungs; padding past it would multiply the sweep work and the
    move planes); without (CPU runs, where compiling is cheap and padding
    is not) bp is None and padded_batch picks the next power of two.
    Returns [(lo, hi, bp_or_None), ...]."""
    if k <= 0:
        return []
    n = -(-k // step)
    size = -(-k // n)
    out = []
    lo = 0
    while lo < k:
        hi = min(k, lo + size)
        bp = None
        if ladder:
            for v in _BP_LADDER:
                if v >= hi - lo and v <= step:
                    bp = v
                    break
            else:
                bp = step
        out.append((lo, hi, bp))
        lo = hi
    return out

# canonical (cap, band) shape tiers: every device batch is padded to one of
# these so the XLA program set stays small and the (persistent) compile
# cache hot. Items are bucketed to the FIRST tier that fits both their
# length and their length mismatch (band must absorb |n-m| plus drift), so
# each cap offers a narrow band for the common case and a wide variant that
# keeps high-drift layers off the host fallback (which costs full-matrix NW
# per item). Only tiers a workload actually uses get compiled.
_TIERS = ((256, 128), (640, 128), (1280, 256), (1280, 512), (2560, 384),
          (2560, 768), (5120, 512), (5120, 1024), (10240, 768),
          (10240, 2048))


def _round_up(x: int, a: int) -> int:
    return -(-x // a) * a


def _margin(w_band: int) -> int:
    return w_band // 2 - 32


def _concat_off(parts: list[np.ndarray]):
    """(blob, offsets) of a list of 1-D arrays."""
    off = np.zeros(len(parts) + 1, np.int64)
    lens = np.fromiter((len(p) for p in parts), np.int64, len(parts))
    np.cumsum(lens, out=off[1:])
    blob = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return blob, off


def _nthr() -> int:
    return os.cpu_count() or 2


def _flat_ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Flat index array covering [starts[i], starts[i]+lens[i]) per i —
    the vectorized replacement for per-item slice loops. Uses int32 when
    the source fits (half the index-array memory traffic)."""
    total = int(lens.sum())
    if not total:
        return np.zeros(0, np.int64)
    starts = np.asarray(starts)
    hi = int(starts.max()) + int(lens.max())
    dt = np.int32 if hi < 2**31 and total < 2**31 else np.int64
    ends = np.cumsum(lens)
    # fold both per-item offsets into ONE repeat: base = starts - range_start
    base = starts.astype(dt) - (ends - lens).astype(dt)
    return np.repeat(base, lens) + np.arange(total, dtype=dt)


def device_scores_ok(cfg) -> bool:
    """Whether the device path supports cfg's scores: the sweep's NEG
    sentinel must stay far below every real cell value."""
    return not (cfg.gap < -120 or cfg.match > 120 or cfg.mismatch < -120)


class DeviceConsensusStage:
    """kernels=True runs the CUDA sweep (accelerator only); False runs
    XLA's compile of the jnp reference on whatever platform JAX has."""

    def __init__(self, cfg, kernels: bool):
        import jax

        self.cfg = cfg
        self.kernels = kernels
        self.ladder = jax.devices()[0].platform != "cpu"
        self.stats = {"device_items": 0, "host_items": 0,
                      "tiers": Counter()}

    @staticmethod
    def _cohorts(n_active: int, passes: int) -> int:
        """Pipeline depth: cohorts whose rounds interleave, so one cohort's
        host merge runs while another's device dispatch is in flight."""
        return 3 if n_active >= 256 and passes >= 2 else 1

    def consensus_windows(self, windows, cfg, logger):
        from ..core.windows import WINDOW_TYPE_TGS
        from ..native import bindings

        # wall-time ledger: host prep+launch, blocking payload fetch
        # (device wait + D2H; an UNDERestimate of device busy time — other
        # cohorts' dispatches overlap the host merge), and the host
        # merge+decode remainder
        self.prof = defaultdict(float)

        n_win = windows.num_windows
        tgs = windows.window_type == WINDOW_TYPE_TGS

        # windows with <2 layers pass through (reference: src/window.cpp:68-71)
        consensus: list[bytes | None] = [None] * n_win
        polished = [False] * n_win
        active = []
        for w in range(n_win):
            if windows.n_layers(w) < 2:
                consensus[w] = windows.backbone(w).tobytes()
            else:
                active.append(w)
        if not active:
            return [c or b"" for c in consensus], polished

        # ---- static per-item structure (fixed across refinement rounds):
        # items are all (window, layer) pairs grouped by window in `active`
        # order, which is exactly the layout rt_poa_round_batch consumes.
        # The accelerator path caps layers per window like the reference's
        # GPU path (MAX_DEPTH_PER_WINDOW=200, src/cuda/cudapolisher.cpp:226;
        # layers are begin-sorted, extra ones are dropped like cudapoa's
        # batch-full rejection); the native/CPU path uses all layers, like
        # the reference's CPU path.
        st = _StaticItems(windows, active,
                          depth_cap=max(1, cfg.max_window_depth))

        # refinement state per active window
        gap = cfg.gap
        state = _RoundState(windows, active, gap)

        # ceiling on backbone expansion: the largest canonical tier that
        # could ever be needed for this window set (items are bucketed to
        # per-round tiers from their ACTUAL lengths in _round_dispatch)
        needed = max(int(st.lay_len.max(initial=0)),
                     2 * state.max_backbone + 64, 256)
        for cap, _ in _TIERS:
            if needed <= cap:
                break
        else:
            cap = _round_up(needed, 1024)
        max_expand = cap

        passes = max(1, cfg.refine_passes)

        # cohort pipelining (the reference's fill/process loop plays this
        # role for its GPU batches, src/cuda/cudapolisher.cpp:83-144)
        n_coh = max(1, min(self._cohorts(len(active), passes), len(active)))

        class _Cohort:
            pass

        cohorts = []
        bounds = np.linspace(0, len(active), n_coh + 1).astype(int)
        for ci in range(n_coh):
            part = active[bounds[ci] : bounds[ci + 1]]
            if not part:
                continue
            co = _Cohort()
            co.active = part
            if n_coh == 1:
                co.st, co.state = st, state
            else:
                co.st = st.subset(np.arange(bounds[ci], bounds[ci + 1]))
                co.state = _RoundState(windows, part, gap)
            cohorts.append(co)

        pend = [None] * len(cohorts)
        pass_no = [0] * len(cohorts)
        total_units = len(active) * passes  # window-rounds, for progress
        done_units = 0
        for ci, co in enumerate(cohorts):
            t0 = time.perf_counter()
            pend[ci] = self._round_dispatch(windows, cfg, co.active, co.st,
                                            co.state, max_expand, bindings)
            self.prof["dispatch_s"] += time.perf_counter() - t0
        while any(p is not None for p in pend):
            for ci, co in enumerate(cohorts):
                if pend[ci] is None:
                    continue
                final = pass_no[ci] == passes - 1
                t0 = time.perf_counter()
                retired = self._round_complete(pend[ci], cfg, final, tgs,
                                               consensus, polished, bindings)
                self.prof["merge_s"] += (time.perf_counter() - t0
                                         - self.prof.pop("_fetch_last", 0.0))
                pend[ci] = None
                pass_no[ci] += 1
                done_units += len(co.active)
                if retired:  # converged: their remaining rounds are done too
                    done_units += len(retired) * (passes - pass_no[ci])
                logger.bar_progress(
                    "[racon::Polisher::polish] generating consensus",
                    done_units, total_units)
                if pass_no[ci] >= passes:
                    continue
                if retired:
                    # converged windows were finalized in-round; later
                    # rounds would reproduce their state bit-for-bit
                    keep_z = np.array([z for z, w in enumerate(co.active)
                                       if w not in retired], np.int64)
                    co.active = [co.active[z] for z in keep_z]
                    if co.active:
                        co.st = co.st.subset(keep_z)
                        co.state.subset(keep_z)
                if co.active:
                    t0 = time.perf_counter()
                    pend[ci] = self._round_dispatch(
                        windows, cfg, co.active, co.st, co.state, max_expand,
                        bindings)
                    self.prof["dispatch_s"] += time.perf_counter() - t0
        logger.bar_progress("[racon::Polisher::polish] generating consensus",
                            total_units, total_units)
        return [c if c is not None else b"" for c in consensus], polished

    # ------------------------------------------------------------------ #

    def _round_dispatch(self, windows, cfg, active, st, state, max_expand,
                        bindings):
        """First half of a refinement round: per-round state prep, tier
        bucketing, and the (async) device dispatches. Returns the round
        context consumed by _round_complete — between the two calls the
        device works while the host is free for another cohort's merge."""
        gap = cfg.gap
        thr = cfg.num_threads
        n_items = st.n_items

        # 1. per-round backbone blobs (already flat in the state) + span
        # projection: per-window slot arrays are ascending, so each item's
        # [begin, end] maps to a slot range by binary search (native,
        # threaded)
        cur_blob = state.cur
        bb_off = state.off
        lens = np.diff(bb_off)
        cur_enc = encode(cur_blob).astype(np.int8)
        del32 = state.dcost
        del8 = del32.astype(np.int8)
        curw_blob = state.w

        sb, se = bindings.project_spans(
            state.slots, bb_off, st.item_wz,
            windows.lay_begin[st.item_li], windows.lay_end[st.item_li], thr)
        nlen = se - sb + 1
        mlen = st.lay_len
        t_start = bb_off[st.item_wz] + sb
        t_end = bb_off[st.item_wz] + se + 1

        # 2. bucket items into the smallest tier that fits length and
        # mismatch; oversized/over-drifted items run on the host pool
        tiers = [t for t in _TIERS if t[0] <= max_expand] or [_TIERS[0]]
        tier_id = np.full(n_items, -1, np.int64)
        for ti, (cap, wb) in enumerate(tiers):
            ok = ((tier_id < 0) & (mlen <= cap) & (nlen <= cap)
                  & (np.abs(nlen - mlen) <= _margin(wb)))
            tier_id[ok] = ti

        # coalesce small tiers into a compatible bigger used tier: every
        # device chunk pays a fixed dispatch+fetch round trip, so a few
        # hundred short items are cheaper re-padded into a bigger tier's
        # batch than as their own dispatch. Promotion target needs cap >=
        # and band >= (band implies the |n-m| margin).
        counts = np.bincount(tier_id[tier_id >= 0], minlength=len(tiers))
        for ti, (cap, wb) in enumerate(tiers):
            if not 0 < counts[ti] < 1024:
                continue
            for tj in range(ti + 1, len(tiers)):
                cj, wj = tiers[tj]
                if (cj >= cap and wj >= wb and counts[tj] > 0
                        and counts[ti] <= counts[tj]):
                    tier_id[tier_id == ti] = tj
                    counts[tj] += counts[ti]
                    counts[ti] = 0
                    break

        cnt = np.zeros(n_items, np.int64)
        host_parts = [np.flatnonzero(tier_id < 0)]

        # 3. device alignment: one fused align+walk dispatch per chunk; all
        # chunks are dispatched before any result is fetched so H2D, compute
        # and D2H pipeline across chunks (async dispatch)
        pending = []
        for ti, (cap, w_band) in enumerate(tiers):
            dev_idx = np.flatnonzero(tier_id == ti)
            if len(dev_idx):
                self.stats["tiers"][(cap, w_band)] += len(dev_idx)
            step = _chunk_size(cap, w_band)
            for lo, hi, cbp in chunk_plan(len(dev_idx), step, self.ladder):
                sel = dev_idx[lo:hi]
                # one compiled shape per big tier; other tiers pad to the
                # canonical _BP_LADDER size (chunk_plan)
                fixed_b = step if cap >= 5120 and self.ladder else cbp
                q4 = bindings.pack_rows_nib(
                    st.lay_codes, st.lay_off[sel],
                    st.lay_off[sel] + mlen[sel], cap, PAD_CODE, thr)
                t4 = bindings.pack_rows_nib(cur_enc, t_start[sel],
                                            t_end[sel], cap, PAD_CODE, thr)
                dcb = bindings.pack_rows_bits(del8, t_start[sel],
                                              t_end[sel], cap, thr)
                payload, _ = align_walk_padded(
                    q4, t4, dcb, mlen[sel].astype(np.int32),
                    nlen[sel].astype(np.int32), m_cap=cap, n_cap=cap,
                    w_band=w_band, match=cfg.match, mismatch=cfg.mismatch,
                    gap=gap, kernel=self.kernels, fixed_b=fixed_b)
                payload.copy_to_host_async()  # overlap D2H with compute
                # start pulling the payload to host now on a worker thread
                # so fetches overlap each other and the other cohorts'
                # merges (the reference's producer/consumer batch overlap,
                # src/cuda/cudapolisher.cpp:83-144,254-333)
                fut = prefetch.submit(payload)
                pending.append((sel, cap, w_band, payload, fut))
                self.stats["device_items"] += len(sel)
        return dict(active=active, st=st, state=state, max_expand=max_expand,
                    n_items=n_items, cur_blob=cur_blob, bb_off=bb_off,
                    lens=lens, curw_blob=curw_blob, del32=del32, sb=sb,
                    t_start=t_start, mlen=mlen, nlen=nlen, cnt=cnt,
                    host_parts=host_parts, pending=pending)

    def _round_complete(self, ctx, cfg, final, tgs, consensus, polished,
                        bindings):
        """Second half of a refinement round: fetch + decode the device
        payloads, host-realign band escapes, merge the round natively, and
        replace the cohort's state. Returns the retired (converged) window
        ids."""
        gap = cfg.gap
        thr = cfg.num_threads
        st = ctx["st"]
        max_expand = ctx["max_expand"]
        n_items = ctx["n_items"]
        cur_blob = ctx["cur_blob"]
        bb_off = ctx["bb_off"]
        lens = ctx["lens"]
        curw_blob = ctx["curw_blob"]
        del32 = ctx["del32"]
        sb = ctx["sb"]
        t_start = ctx["t_start"]
        mlen = ctx["mlen"]
        nlen = ctx["nlen"]
        cnt = ctx["cnt"]
        host_parts = ctx["host_parts"]

        # 4. decode the op streams IN PLACE into the merge's padded per-item
        # layout (capacity m+n+2 runs per item — a real stream never yields
        # more): no per-chunk allocation, no assembly gather. The backing
        # buffer is grow-only and reused across rounds/cohorts (calls never
        # overlap): a fresh np.empty per round re-pays soft page faults on
        # every touched page of a ~100MB+ region.
        ops_off2 = np.zeros(n_items + 1, np.int64)
        np.cumsum(mlen + nlen + 2, out=ops_off2[1:])
        need = int(ops_off2[-1]) * 2
        buf = getattr(self, "_ops_scratch", None)
        if buf is None or buf.size < need:
            buf = np.empty(need + need // 4, np.int32)
            self._ops_scratch = buf
        ops_blob = buf[:need].reshape(-1, 2)
        fetch_s = 0.0
        _t_dec = time.perf_counter()
        for sel, cap, w_band, payload, fut in ctx["pending"]:
            tf = time.perf_counter()
            payload = prefetch.resolve(payload, fut)[: len(sel)]
            fetch_s += time.perf_counter() - tf
            escaped = payload[:, -1] != 0
            codes = np.ascontiguousarray(payload[:, :-1])
            _, _, counts = bindings.opstream_packed_to_ops_batch(
                codes, walk_steps(cap, cap, w_band), mlen[sel], nlen[sel],
                thr, dst=ops_blob, dst_off=ops_off2[:-1][sel])
            kept = ~escaped
            host_parts.append(sel[escaped])  # band escape -> host realign
            cnt[sel[kept]] = counts[kept]
        self.prof["fetch_s"] += fetch_s
        self.prof["_fetch_last"] = fetch_s
        self.prof["decode_s"] += time.perf_counter() - _t_dec - fetch_s

        # host fallback alignment (per-column costs)
        host_idx = np.concatenate(host_parts)
        self.prof["host_fallback_items"] += len(host_idx)
        self.stats["host_items"] += len(host_idx)
        _t_hf = time.perf_counter()
        if len(host_idx):
            hm = mlen[host_idx]
            hn = nlen[host_idx]
            qoff = np.zeros(len(host_idx) + 1, np.int64)
            np.cumsum(hm, out=qoff[1:])
            toff = np.zeros(len(host_idx) + 1, np.int64)
            np.cumsum(hn, out=toff[1:])
            qblob = bindings.gather_ranges(st.lay_blob, st.lay_off[host_idx],
                                           hm, thr)
            tsel = _flat_ranges(t_start[host_idx], hn)
            ops_flat, ops_off, counts = bindings.align_batch_percol(
                qblob, qoff, cur_blob[tsel], toff, del32[tsel], cfg.match,
                cfg.mismatch, gap, thr)
            cnt[host_idx] = counts
            bindings.gather_ranges(ops_flat, ops_off[:-1], counts, thr,
                                   dst=ops_blob,
                                   dst_off=ops_off2[:-1][host_idx])
        self.prof["host_fallback_s"] += time.perf_counter() - _t_hf
        _t_mg = time.perf_counter()

        # 5. merge round per window (native)
        capacity = 2 * lens + 512
        res = bindings.poa_round_batch(
            cur_blob, bb_off, curw_blob, st.item_off,
            st.lay_blob, st.lay_off, st.layw_blob,
            sb.astype(np.int32), ops_blob, ops_off2,
            final, tgs, cfg.trim, gap, cfg.candidate_frac,
            cfg.candidate_min, max_expand, st.win_id, st.win_rank,
            thr, capacity, with_final=not final, ops_cnt=cnt)
        self.prof["poa_round_s"] += time.perf_counter() - _t_mg
        _t_gl = time.perf_counter()
        try:
            return self._finish_round(ctx, final, res, consensus, polished,
                                      bindings)
        finally:
            self.prof["stateglue_s"] += time.perf_counter() - _t_gl

    def _finish_round(self, ctx, final, res, consensus, polished, bindings):
        """Tail of _round_complete: emit finals / convergence retirement /
        state replacement (split out so the glue can be timed)."""
        active = ctx["active"]
        state = ctx["state"]
        bb_off = ctx["bb_off"]
        lens = ctx["lens"]
        thr = self.cfg.num_threads
        out_blob, out_off, out_len, out_del, out_slots, out_pol = res[:6]

        n_act = len(active)
        retired: set[int] = set()
        if final:
            raw = out_blob.tobytes()
            for z, w in enumerate(active):
                o = int(out_off[z])
                consensus[w] = raw[o : o + int(out_len[z])]
                polished[w] = bool(out_pol[z])
            return retired

        # convergence + speculative finals come straight from the merge:
        # the round was a fixed point (same backbone, deletion costs, slot
        # map, zero backbone weights), so later rounds would reproduce the
        # graph bit-for-bit and fin_blob already holds the final consensus.
        fin_blob, fin_len, fin_pol, conv = res[6:]
        conv &= ~state.has_w  # round must have run with zero weights
        conv_z = np.flatnonzero(conv)
        if len(conv_z):
            retired = {active[int(z)] for z in conv_z}
            raw = fin_blob.tobytes()
            for z in conv_z:
                z = int(z)
                o = int(out_off[z])
                consensus[active[z]] = raw[o : o + int(fin_len[z])]
                polished[active[z]] = bool(fin_pol[z])

        # vectorized state replacement: gather the merge outputs into fresh
        # flat blobs, compose slots through to original coordinates (one
        # threaded native pass straight off the merge's padded layout)
        new_len = out_len.astype(np.int64)
        starts = out_off[:n_act]
        new_cur = bindings.gather_ranges(out_blob, starts, new_len, thr)
        new_del = bindings.gather_ranges(out_del, starts, new_len, thr)
        new_slots, new_off = bindings.compose_slots(
            state.slots, bb_off, lens, out_slots, starts, new_len, thr)

        state.cur = new_cur
        state.dcost = new_del
        state.slots = new_slots
        state.off = new_off
        state.w = np.zeros(len(new_cur), np.int32)
        state.has_w = np.zeros(n_act, bool)
        return retired


class _StaticItems:
    """Round-invariant item layout: flat blobs + offsets for every
    (window, layer) pair, grouped by window in `active` order."""

    def __init__(self, windows, active, depth_cap=None):
        item_li_parts = [np.asarray(windows.layer_indices(w)[:depth_cap],
                                    np.int64)
                         for w in active]
        self.item_li = (np.concatenate(item_li_parts) if item_li_parts
                        else np.zeros(0, np.int64))
        counts = np.fromiter((len(p) for p in item_li_parts), np.int64,
                             len(active))
        self.item_off = np.zeros(len(active) + 1, np.int64)
        np.cumsum(counts, out=self.item_off[1:])
        self.item_wz = np.repeat(np.arange(len(active)), counts)
        self.n_items = int(self.item_off[-1])

        # vectorized layer blob/weights gather (no per-item python): layers
        # are slices of the store's forward blob or of prepared revcomps
        li = self.item_li
        store = windows.sequences
        qid = windows.lay_qid[li]
        strand = windows.lay_strand[li]
        qb = windows.lay_qbegin[li]
        qlen = windows.lay_qlen[li].astype(np.int64)
        self.lay_off = np.zeros(self.n_items + 1, np.int64)
        np.cumsum(qlen, out=self.lay_off[1:])
        self.lay_len = qlen
        rc_blob, rc_start = store.rc_arrays()
        rq_blob, rq_start = store.rq_arrays()
        hasq = store.qual_off[qid + 1] > store.qual_off[qid]
        # items are gathered IN ORDER, so one combined-source gather covers
        # everything with a single flat index array and no destination
        # indices: forward layers read the store blob, reverse layers read
        # the (appended) revcomp blob
        from ..native import bindings

        base = np.where(strand, len(store.blob) + rc_start[qid],
                        store.data_off[qid]) + qb
        src = np.concatenate([store.blob, rc_blob])
        blob = bindings.gather_ranges(src, base, qlen, _nthr())
        # weights: gather quality the same way (zeros for no-quality
        # layers via the pad tail, fixed up by the expanded mask),
        # phred-shift, default 1
        if not hasq.any():
            weights = np.ones(int(self.lay_off[-1]), np.int32)
        else:
            qbase = np.where(strand, len(store.qual_blob) + rq_start[qid],
                             store.qual_off[qid]) + qb
            pad = int(qlen.max(initial=0)) + 1
            qbase = np.where(hasq, qbase,
                             len(store.qual_blob) + len(rq_blob))
            qsrc = np.concatenate([store.qual_blob, rq_blob,
                                   np.zeros(pad, np.uint8)])
            q8 = bindings.gather_ranges(qsrc, qbase, qlen, _nthr())
            weights = q8.astype(np.int32) - PHRED_OFFSET
            if not hasq.all():
                weights[~np.repeat(hasq, qlen)] = 1
        self.lay_blob = blob
        self.lay_codes = encode(blob).astype(np.int8)
        self.layw_blob = weights
        self.win_id = np.array([windows.win_target[w] for w in active],
                               np.int64)
        self.win_rank = np.array([windows.win_rank[w] for w in active],
                                 np.int32)

    def subset(self, keep_z: np.ndarray) -> "_StaticItems":
        """Blobs for a subset of windows (indices into the current active
        list): slices the existing flat arrays — no re-gather, no
        re-encode."""
        s = object.__new__(_StaticItems)
        counts = self.item_off[keep_z + 1] - self.item_off[keep_z]
        ksel = _flat_ranges(self.item_off[keep_z], counts)
        s.item_li = self.item_li[ksel]
        s.item_off = np.zeros(len(keep_z) + 1, np.int64)
        np.cumsum(counts, out=s.item_off[1:])
        s.item_wz = np.repeat(np.arange(len(keep_z)), counts)
        s.n_items = int(s.item_off[-1])
        klen = self.lay_len[ksel]
        s.lay_off = np.zeros(s.n_items + 1, np.int64)
        np.cumsum(klen, out=s.lay_off[1:])
        s.lay_len = klen
        from ..native import bindings
        starts = self.lay_off[ksel]
        s.lay_blob = bindings.gather_ranges(self.lay_blob, starts, klen,
                                            _nthr())
        s.lay_codes = bindings.gather_ranges(self.lay_codes, starts, klen,
                                             _nthr())
        s.layw_blob = bindings.gather_ranges(self.layw_blob, starts, klen,
                                             _nthr())
        s.win_id = self.win_id[keep_z]
        s.win_rank = self.win_rank[keep_z]
        return s


class _RoundState:
    """Per-window refinement state in flat-blob form, aligned with the
    active window list: current backbone bytes, per-column weights and
    deletion costs, and the slot->original-position map share `off`."""

    def __init__(self, windows, active, gap):
        self.cur, self.off = _concat_off(
            [np.asarray(windows.backbone(w)) for w in active])
        total = len(self.cur)
        lens = np.diff(self.off)
        self.w = np.zeros(total, np.int32)
        for z, wid in enumerate(active):  # backbone quality, round 1 only
            bq = windows.backbone_quality(wid)
            if bq is not None:
                self.w[self.off[z] : self.off[z + 1]] = (
                    bq.astype(np.int32) - PHRED_OFFSET)
        self.dcost = np.full(total, gap, np.int32)
        self.slots = (np.arange(total, dtype=np.int64)
                      - np.repeat(self.off[:-1], lens))
        self.has_w = (np.add.reduceat(np.abs(self.w), self.off[:-1]) > 0
                      if total else np.zeros(0, bool))
        self.max_backbone = int(lens.max(initial=0))

    def subset(self, keep_z: np.ndarray) -> None:
        """Drop retired windows in place (indices into the active list)."""
        from ..native import bindings
        lens = np.diff(self.off)[keep_z]
        starts = self.off[keep_z]
        thr = _nthr()
        self.cur = bindings.gather_ranges(self.cur, starts, lens, thr)
        self.w = bindings.gather_ranges(self.w, starts, lens, thr)
        self.dcost = bindings.gather_ranges(self.dcost, starts, lens, thr)
        self.slots = bindings.gather_ranges(self.slots, starts, lens, thr)
        self.off = np.zeros(len(keep_z) + 1, np.int64)
        np.cumsum(lens, out=self.off[1:])
        self.has_w = self.has_w[keep_z]
