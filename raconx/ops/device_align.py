"""Device overlap-alignment stage: breaking points via the Myers sweep.

Replaces the reference's edlib stage (src/overlap.cpp:205-224) and its CUDA
batch aligner (src/cuda/cudaaligner.cpp): overlap (query-slice, target-slice)
pairs are bucketed by length into canonical equal-cap shapes, aligned on
device with the Myers bit-vector sweep (edit distance, scores (0,-1,-1)),
walked on device into compact per-row records, then cut at window
boundaries by the native runtime. Oversized or band-escaping items fall
back to the host C++ aligner (the same heterogeneous-fallback pattern as
the reference's GPU path, src/cuda/cudapolisher.cpp:204-213).
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from . import prefetch
from .device_consensus import chunk_plan, chunk_size
from .myers_kernel import align_walk_myers_padded
from .nw_kernel import encode, PAD_CODE

# canonical (cap, band) tiers; items beyond the last tier go to the host.
# The 4096-band tiers catch high-drift overlaps (error-threshold 0.3 allows
# |qspan-tspan| up to 30%) that would otherwise hit the serial host aligner.
_TIERS = ((2560, 512), (10240, 1024), (40960, 1024), (10240, 4096),
          (40960, 4096))


def _chunk_size(cap: int, band: int) -> int:
    # overlap slices are long: cap chunks at 1024 items (device-memory
    # budget shared with device_consensus.chunk_size)
    return chunk_size(cap, band, 1024)


class DeviceAlignStage:
    """kernels=True runs the CUDA Myers sweep (accelerator only); False
    runs XLA's compile of the jnp reference on whatever platform JAX has."""

    def __init__(self, cfg, kernels: bool):
        import jax

        self.cfg = cfg
        self.kernels = kernels
        self.ladder = jax.devices()[0].platform != "cpu"
        self.stats = {"device_items": 0, "host_items": 0,
                      "tiers": Counter()}

    def breaking_points(self, overlaps, indices, sequences, window_length,
                        logger) -> list[np.ndarray]:
        from ..native import bindings

        # materialize the aligned slices (reference: src/overlap.cpp:192-197)
        # in flat columnar form: strand slices read the (prepared) revcomp
        # blob, forward slices the store blob — one threaded ranged gather
        # per side, no per-overlap python
        thr = self.cfg.num_threads
        idx = np.asarray(indices, np.int64)
        qid = np.asarray(overlaps.q_id)[idx]
        strand = np.asarray(overlaps.strand)[idx].astype(np.uint8)
        qb = np.asarray(overlaps.q_begin)[idx].astype(np.int64)
        qe = np.asarray(overlaps.q_end)[idx].astype(np.int64)
        qlen_full = np.asarray(overlaps.q_length)[idx].astype(np.int64)
        tb = np.asarray(overlaps.t_begin)[idx].astype(np.int64)
        te = np.asarray(overlaps.t_end)[idx].astype(np.int64)
        tid = np.asarray(overlaps.t_id)[idx]
        meta = {"q_begin": qb, "q_end": qe, "q_length": qlen_full,
                "t_begin": tb, "t_end": te}
        rc_blob, rc_start = sequences.rc_arrays()
        src = np.concatenate([sequences.blob, rc_blob])
        qstart = np.where(
            strand != 0,
            len(sequences.blob) + rc_start[qid] + qlen_full - qe,
            sequences.data_off[qid] + qb)
        mlen = qe - qb
        nlen = te - tb
        tstart = sequences.data_off[tid] + tb
        qblob_raw = bindings.gather_ranges(src, qstart, mlen, thr)
        tblob_raw = bindings.gather_ranges(sequences.blob, tstart, nlen, thr)
        qoff_all = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(mlen, out=qoff_all[1:])
        toff_all = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(nlen, out=toff_all[1:])
        qenc = encode(qblob_raw).astype(np.int8)
        tenc = encode(tblob_raw).astype(np.int8)

        # bucket by the canonical tiers; |n - m| must fit well within band.
        # --band-width N sets a minimum device band (reference:
        # --cudaaligner-band-width, src/cuda/cudapolisher.cpp:150-174; 0 =
        # automatic — the tier ladder already adapts per item)
        tiers = _TIERS
        if self.cfg.band_width > 0:
            tiers = (tuple(t for t in tiers if t[1] >= self.cfg.band_width)
                     or (tiers[-1],))
        tier_id = np.full(len(indices), -1, np.int64)
        for ti, (cap, band) in enumerate(tiers):
            ok = ((tier_id < 0) & (mlen <= cap) & (nlen <= cap)
                  & (np.abs(nlen - mlen) <= band // 2 - 64))
            tier_id[ok] = ti
        host: list[int] = list(np.flatnonzero(tier_id < 0))

        all_ops: list[np.ndarray | None] = [None] * len(indices)
        all_counts = np.zeros(len(indices), np.int64)

        # one fused align+walk dispatch per chunk, with the number of
        # in-flight chunks THROTTLED by their device-memory footprint (the
        # sweep's bit planes): letting every chunk queue at once can demand
        # more memory than the card has. Draining also overlaps the host
        # decode with the next chunk's device compute.
        from collections import deque

        pending: deque = deque()
        inflight = [0]
        _INFLIGHT_BYTES = 4 << 30

        def _chunk_bytes(cap, band, k):
            return (cap // 16) * band * 4 * k

        done = [0]  # completed items, for honest 20-bin progress

        def _drain_one():
            sel, cap, payload, fut, nbytes = pending.popleft()
            inflight[0] -= nbytes
            payload = prefetch.resolve(payload, fut)[: len(sel)]
            escaped = payload[:, -1] != 0
            ops_flat, ops_off, counts = bindings.opstream_rows_to_ops_batch(
                payload, cap + 2, mlen[sel], nlen[sel], thr)
            for bi, z in enumerate(sel):
                if escaped[bi]:
                    host.append(z)
                else:
                    o = int(ops_off[bi])
                    all_ops[z] = ops_flat[o : o + int(counts[bi])]
                    all_counts[z] = counts[bi]
            done[0] += len(sel) - int(escaped.sum())
            logger.bar_progress(
                "[racon::Polisher::initialize] aligning overlaps",
                done[0], len(indices))

        for ti, (cap, band) in enumerate(tiers):
            members = np.flatnonzero(tier_id == ti)
            if len(members):
                self.stats["tiers"][(cap, band)] += len(members)
            # sort by length: a chunk's items then have similar real lengths
            members = members[np.argsort(mlen[members], kind="stable")]
            step = _chunk_size(cap, band)
            for lo, hi, cbp in chunk_plan(len(members), step, self.ladder):
                sel = members[lo:hi]
                nbytes = _chunk_bytes(cap, band, len(sel))
                while pending and inflight[0] + nbytes > _INFLIGHT_BYTES:
                    _drain_one()
                q4 = bindings.pack_rows_nib(qenc, qoff_all[sel],
                                            qoff_all[sel] + mlen[sel], cap,
                                            PAD_CODE, thr)
                t4 = bindings.pack_rows_nib(tenc, toff_all[sel],
                                            toff_all[sel] + nlen[sel], cap,
                                            PAD_CODE, thr)
                payload, _ = align_walk_myers_padded(
                    q4, t4, mlen[sel].astype(np.int32),
                    nlen[sel].astype(np.int32), m_cap=cap, n_cap=cap,
                    w_band=band, kernel=self.kernels,
                    # one compiled shape per big tier; small tiers pad to
                    # the canonical _BP_LADDER batch (chunk_plan)
                    fixed_b=step if cap >= 5120 and self.ladder else cbp)
                payload.copy_to_host_async()  # overlap D2H with compute
                # a worker starts pulling the payload now, so fetches
                # overlap across chunks (ops/prefetch.py)
                fut = prefetch.submit(payload)
                pending.append((sel, cap, payload, fut, nbytes))
                inflight[0] += nbytes
                self.stats["device_items"] += len(sel)
        while pending:
            _drain_one()
        self.stats["host_items"] += len(host)

        if host:
            hz = np.asarray(host, np.int64)
            hm = mlen[hz]
            hn = nlen[hz]
            qoff = np.zeros(len(hz) + 1, np.int64)
            np.cumsum(hm, out=qoff[1:])
            toff = np.zeros(len(hz) + 1, np.int64)
            np.cumsum(hn, out=toff[1:])
            qblob = bindings.gather_ranges(qblob_raw, qoff_all[hz], hm, thr)
            tblob = bindings.gather_ranges(tblob_raw, toff_all[hz], hn, thr)
            ops_flat, ops_off, counts = bindings.align_batch(
                qblob, qoff, tblob, toff, 0, -1, -1, True,
                self.cfg.num_threads)
            for z2, z in enumerate(host):
                o = int(ops_off[z2])
                all_ops[z] = ops_flat[o : o + int(counts[z2])]
                all_counts[z] = counts[z2]

        # op lists -> window breaking points (native walk)
        ops_off2 = np.zeros(len(indices) + 1, np.int64)
        for z in range(len(indices)):
            ops_off2[z + 1] = ops_off2[z] + len(all_ops[z])
        ops_blob = (np.concatenate(all_ops) if len(indices)
                    else np.zeros((0, 2), np.int32))
        quads, quad_off, qcounts = bindings.breaking_points_from_ops_batch(
            ops_blob, ops_off2[:-1], all_counts, strand, meta["q_begin"],
            meta["q_end"], meta["q_length"], meta["t_begin"], meta["t_end"],
            window_length, self.cfg.num_threads)
        out = []
        for z in range(len(indices)):
            o = int(quad_off[z])
            out.append(quads[o : o + int(qcounts[z])].copy())
        logger.bar_progress("[racon::Polisher::initialize] aligning overlaps",
                            len(indices), len(indices))
        return out
