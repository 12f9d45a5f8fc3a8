#!/usr/bin/env python
"""Benchmark: POA window consensus throughput on one GPU.

Workload: synthetic ONT-like window batch (500 bp backbones, ~12% read error,
depth 20), polished end-to-end through the consensus stage (device banded-NW
alignment + on-device traceback walk + native star-POA merge, 4 refinement
passes — the production path). Baseline = the same workload through the
native CPU backend (the racon-equivalent host path) using all host threads;
vs_baseline = device_windows_per_s / cpu_windows_per_s.

Needs a GPU: without one it exits non-zero and prints no rate. Every ledger
names the device (platform, device_kind, count, card and power limit).
Prints ONE JSON line; the full ledger goes to BENCH_LEDGER.json.
"""

import json
import statistics
import sys
import time

import numpy as np

N_WINDOWS = 2048  # large enough to fill the card (fixed per-dispatch
                  # costs amortize like a genome-scale run)
WINDOW_LEN = 500
DEPTH = 20
ERR = 0.12
REPEATS = 3  # median of repeated warm runs


def _mutate_read(rng, seg):
    """Vectorized ONT-like read simulation: per-base del/ins/sub at ERR."""
    ACGT = np.frombuffer(b"ACGT", np.uint8)
    r = rng.random(len(seg))
    keep = r >= ERR / 3                      # deletions
    ins = r < 2 * ERR / 3
    ins &= keep  # insertion after a kept base (matches the scalar version:
    # the branch ordering made dels and inss disjoint)
    sub = (r >= 2 * ERR / 3) & (r < ERR)
    base = seg.copy()
    base[sub] = ACGT[rng.integers(0, 4, int(sub.sum()))]
    # interleave: emit kept base, then an inserted random base where ins
    out_len = keep.astype(np.int64) + ins.astype(np.int64)
    off = np.zeros(len(seg) + 1, np.int64)
    np.cumsum(out_len, out=off[1:])
    read = np.empty(int(off[-1]), np.uint8)
    read[off[:-1][keep]] = base[keep]
    ipos = off[:-1][ins] + 1
    read[ipos] = ACGT[rng.integers(0, 4, len(ipos))]
    return read


def build_workload(seed=1234, n_windows=None, window_len=None):
    from raconx.core.store import SequenceStore
    from raconx.core.windows import WindowSet, WINDOW_TYPE_TGS

    n_windows = n_windows or N_WINDOWS
    window_len = window_len or WINDOW_LEN
    rng = np.random.default_rng(seed)
    ACGT = np.frombuffer(b"ACGT", np.uint8)
    glen = n_windows * window_len
    true = rng.choice(ACGT, glen)
    draft = true.copy()
    # draft errors: subs + deletions (ONT-like draft)
    for pos in rng.choice(glen, glen // 50, replace=False):
        draft[pos] = rng.choice(ACGT)
    keep = np.delete(np.arange(glen), rng.choice(glen, glen // 100,
                                                 replace=False))
    draft = draft[keep]  # keep[i] = true-coordinate of draft position i

    # store: target (draft) + reads
    names = [b"ctg"]
    parts = [draft]
    qid = 1
    # reads tile the target; each read ~2kb covering 4 windows, staggered
    # so every window sees ~DEPTH layers (read coverage = read_len/step).
    # read r spans draft[start:end]; its error-free source is the matching
    # true-coordinate slice (keep[] maps between the two systems)
    read_len_t = 4 * window_len
    step = max(1, read_len_t // DEPTH)
    for start in range(0, len(draft) - 100, step):
        end = min(start + read_len_t, len(draft))
        seg = true[keep[start] : keep[end - 1] + 1]
        read = _mutate_read(rng, seg)
        names.append(b"r%d" % qid)
        parts.append(read)
        qid += 1

    data_off = np.zeros(len(parts) + 1, np.int64)
    for i, p in enumerate(parts):
        data_off[i + 1] = data_off[i] + len(p)
    store = SequenceStore(names, np.concatenate(parts), data_off,
                          np.zeros(0, np.uint8),
                          np.zeros(len(parts) + 1, np.int64))

    windows = WindowSet(store, 1, window_len, WINDOW_TYPE_TGS)
    # assign layers via the host aligner's breaking points (setup, not timed)
    from raconx.native import bindings

    n_reads = len(parts) - 1
    qoff = np.zeros(n_reads + 1, np.int64)
    toff = np.zeros(n_reads + 1, np.int64)
    spans = []
    for r in range(n_reads):
        read = parts[r + 1]
        tb = min(int(r * step), len(draft) - 1)
        te = min(tb + read_len_t, len(draft))
        spans.append((tb, te))
        qoff[r + 1] = qoff[r] + len(read)
        toff[r + 1] = toff[r] + (te - tb)
    quads, quad_off, counts = bindings.breaking_points_batch(
        np.concatenate(parts[1:]),
        qoff, np.concatenate([draft[b:e] for b, e in spans]), toff,
        np.zeros(n_reads, np.uint8), np.zeros(n_reads, np.int64),
        qoff[1:] - qoff[:-1], qoff[1:] - qoff[:-1],
        np.array([b for b, _ in spans], np.int64),
        np.array([e for _, e in spans], np.int64), window_len, 16)
    for r in range(n_reads):
        o = int(quad_off[r])
        bp = quads[o : o + int(counts[r])]
        windows.assign_overlap(bp, r + 1, 0, False, 10.0)
    windows.freeze()
    return windows, true


def run_stage(stage, windows, cfg):
    from raconx.utils.logger import Logger
    import contextlib, io

    t0 = time.monotonic()
    with contextlib.redirect_stderr(io.StringIO()):
        cons, pol = stage.consensus_windows(windows, cfg, Logger())
    dt = time.monotonic() - t0
    return dt, cons


def bench_kernel_cells(reps=5):
    """Device time of the fused align+walk dispatch at the main consensus
    tier (cap 640, band 128, 4096 items): the CUDA sweep vs XLA's compile
    of the jnp sweep, same inputs, same walk. Host clock around
    block_until_ready, min of `reps` after a warm-up call."""
    import jax

    from raconx.ops.nw_kernel import (align_walk_batch, pack_codes4,
                                      pack_delbits)

    cap, band, B = 640, 128, 4096
    rng = np.random.default_rng(7)
    q8 = rng.integers(0, 4, (B, cap)).astype(np.int8)
    t8 = q8.copy()
    t8[rng.random((B, cap)) < 0.1] = 1
    m = np.full(B, cap - 40, np.int32)
    n = np.full(B, cap - 40, np.int32)
    args = (jax.device_put(pack_codes4(q8)), jax.device_put(pack_codes4(t8)),
            jax.device_put(pack_delbits(np.full((B, cap), -8, np.int8))),
            jax.device_put(m), jax.device_put(n))
    out = {"cap": cap, "band": band, "items": B, "cells": B * cap * band}
    for name, kernel in (("cuda", True), ("xla", False)):
        def call():
            return jax.block_until_ready(align_walk_batch(
                *args, m_cap=cap, n_cap=cap, w_band=band, match=5,
                mismatch=-4, gap=-8, kernel=kernel))
        call()
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            call()
            best = min(best, time.perf_counter() - t0)
        out[f"{name}_seconds"] = best
        out[f"{name}_cells_per_s"] = out["cells"] / best
    return out


def bench_align_stage(cfg, overlaps, targets, reads, datadir):
    """Overlap-alignment stage on the files in `datadir`: overlaps/s
    through the device tier ladder vs the native host aligner (the
    reference edlib role)."""
    import contextlib
    import dataclasses
    import io
    import os

    from raconx.native.align_stage import NativeAlignStage
    from raconx.ops.device_align import DeviceAlignStage
    from raconx.polisher import create_polisher
    from raconx.utils.logger import Logger

    p = create_polisher(os.path.join(datadir, reads),
                        os.path.join(datadir, overlaps),
                        os.path.join(datadir, targets), cfg)
    # run initialize() but intercept the align stage to time both backends
    result = {}
    orig = NativeAlignStage.breaking_points

    def probe(self, overlaps, indices, sequences, window_length, logger):
        sink = Logger()
        with contextlib.redirect_stderr(io.StringIO()):
            t0 = time.monotonic()
            host_bp = orig(NativeAlignStage(cfg), overlaps, indices,
                           sequences, window_length, sink)
            host_dt = time.monotonic() - t0
            result["n_overlaps"] = len(indices)
            result["host_seconds"] = host_dt
            result["host_overlaps_per_s"] = len(indices) / host_dt
            dev = DeviceAlignStage(cfg, kernels=True)
            t0 = time.monotonic()
            dev.breaking_points(overlaps, indices, sequences, window_length,
                                sink)  # warm
            result["device_cold_seconds"] = time.monotonic() - t0
            t0 = time.monotonic()
            dev.breaking_points(overlaps, indices, sequences, window_length,
                                sink)
            dev_dt = time.monotonic() - t0
            result["device_seconds"] = dev_dt
            result["device_overlaps_per_s"] = len(indices) / dev_dt
        return host_bp

    NativeAlignStage.breaking_points = probe
    p.config = dataclasses.replace(cfg, backend="native")
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            p.initialize()
    finally:
        NativeAlignStage.breaking_points = orig
    return result


def bench_align_stage_long(cfg, n_reads=300):
    """Long-overlap align stage: SYNTHETIC 30-38 kb reads against a
    400 kb draft (8% subs + balanced 1.5% indels so the diagonal stays
    within the band). These spans land on the 40960-cap tiers; this entry
    records that tier's device-vs-host stage throughput."""
    import os
    import tempfile

    ACGT = np.frombuffer(b"ACGT", np.uint8)
    rng = np.random.default_rng(4099)
    G = 400_000
    true = rng.choice(ACGT, G)
    draft = true.copy()
    for pos in rng.choice(G, G // 200, replace=False):
        draft[pos] = rng.choice(ACGT)
    with tempfile.TemporaryDirectory(prefix="racon_long_") as td:
        paf = []
        with open(os.path.join(td, "reads.fasta"), "wb") as f:
            for r in range(n_reads):
                rlen = int(rng.integers(30_000, 38_000))
                s = int(rng.integers(0, G - rlen))
                seg = true[s : s + rlen].copy()
                for pos in rng.choice(rlen, int(rlen * 0.08),
                                      replace=False):
                    seg[pos] = rng.choice(ACGT)
                nd = int(rlen * 0.015)
                seg = np.delete(seg, rng.choice(len(seg) - 2, nd,
                                                replace=False))
                ins = rng.choice(len(seg) - 2, nd, replace=False)
                seg = np.insert(seg, ins, rng.choice(ACGT, nd))
                f.write(b">r%d\n" % r + seg.tobytes() + b"\n")
                paf.append("\t".join(map(str, (
                    f"r{r}", len(seg), 0, len(seg), "+", "ctg", G, s,
                    s + rlen, len(seg) * 9 // 10, len(seg), 60))))
        with open(os.path.join(td, "ovl.paf"), "w") as f:
            f.write("\n".join(paf) + "\n")
        with open(os.path.join(td, "draft.fasta"), "wb") as f:
            f.write(b">ctg\n" + draft.tobytes() + b"\n")
        out = bench_align_stage(cfg, overlaps="ovl.paf",
                                targets="draft.fasta", reads="reads.fasta",
                                datadir=td)
    if out is not None:
        out["data"] = "synthetic 30-38 kb reads (40960-cap tier domain)"
    return out


def bench_merge_scaling(dev, windows, cfg, reps=3):
    """Merge-ONLY thread scaling: capture real rt_poa_round_batch calls
    from one stage run (device in the loop only for the capture), then
    replay JUST the native merge at 1 vs N threads. Pins whether the host
    merge itself parallelizes or is serialized elsewhere."""
    import inspect

    from raconx.native import bindings

    captured = []
    orig = bindings.poa_round_batch
    sig = inspect.signature(orig)

    def spy(*a, **k):
        if len(captured) < 3:
            # deep-copy: the stage reuses/mutates its blobs across rounds
            # (in-place decode buffers), so replaying aliased views reads
            # inconsistent data (segfault in the native merge)
            snap_a = tuple(np.array(x, copy=True)
                           if isinstance(x, np.ndarray) else x for x in a)
            snap_k = {kk: (np.array(v, copy=True)
                           if isinstance(v, np.ndarray) else v)
                      for kk, v in k.items()}
            captured.append((snap_a, snap_k))
        return orig(*a, **k)

    bindings.poa_round_batch = spy
    try:
        run_stage(dev, windows, cfg)
    finally:
        bindings.poa_round_batch = orig
    if not captured:
        return {"error": "no merge calls captured"}
    out = {}
    n_win = sum(len(a[1]) - 1 for a, _ in captured)  # cur_off per call
    for thr in (1, 2, cfg.num_threads):
        if f"threads_{thr}" in out:
            continue
        calls = []
        for a, k in captured:
            b = sig.bind(*a, **k)
            b.arguments["n_threads"] = thr
            calls.append((b.args, b.kwargs))
        best = None
        for _ in range(reps):
            t0 = time.monotonic()
            for args, kwargs in calls:
                orig(*args, **kwargs)
            dt = time.monotonic() - t0
            best = dt if best is None else min(best, dt)
        out[f"threads_{thr}"] = {
            "seconds": round(best, 4),
            "window_rounds_per_s": round(n_win / best, 1)}
    t1 = out["threads_1"]["window_rounds_per_s"]
    tN = out[f"threads_{max(2, cfg.num_threads)}"]["window_rounds_per_s"]
    out["scaling_x"] = round(tN / t1, 3) if t1 else None
    return out


def main():
    import os

    from raconx.models.polish_model import PolisherConfig
    from raconx.native.consensus_stage import NativeConsensusStage
    from raconx.ops.device_consensus import DeviceConsensusStage
    from raconx.utils.jaxenv import device_stamp, setup_jax

    setup_jax()
    stamp = device_stamp()
    if stamp["platform"] != "gpu":
        sys.stderr.write(f"[bench] no GPU ({stamp}): nothing to measure\n")
        sys.exit(1)
    cfg = PolisherConfig(backend="gpu", num_threads=os.cpu_count() or 8,
                         match=5, mismatch=-4, gap=-8)
    windows, true = build_workload()

    lay_per_win = (len(windows.lay_win) / windows.num_windows
                   if windows.num_windows else 0.0)
    ledger = {"device": stamp,
              "workload": {"n_windows": windows.num_windows,
                           "window_len": WINDOW_LEN, "depth": DEPTH,
                           "layers_per_window_measured": lay_per_win,
                           "read_error": ERR,
                           "host_threads": cfg.num_threads}}

    # CPU baseline (racon-equivalent host path), once
    cpu_dt, cpu_cons = run_stage(NativeConsensusStage(cfg), windows, cfg)
    cpu_wps = windows.num_windows / cpu_dt
    ledger["consensus_host"] = {"seconds": cpu_dt, "windows_per_s": cpu_wps}

    dev = DeviceConsensusStage(cfg, kernels=True)
    t0 = time.monotonic()
    run_stage(dev, windows, cfg)  # warm-up (compile)
    ledger["consensus_cold_seconds"] = time.monotonic() - t0
    times = []
    profs = []
    for _ in range(REPEATS):
        dt, dev_cons = run_stage(dev, windows, cfg)
        times.append(dt)
        profs.append(dict(dev.prof))
    dev_dt = statistics.median(times)
    dev_wps = windows.num_windows / dev_dt
    prof = profs[times.index(dev_dt)]
    fetch = prof.get("fetch_s", 0.0)
    disp = prof.get("dispatch_s", 0.0)
    merge = prof.get("merge_s", 0.0)
    ledger["consensus_device"] = {
        "seconds": dev_dt,
        "windows_per_s": dev_wps,
        "host_dispatch_s": disp,
        "device_wait_s": fetch,  # underestimates device busy: cohort
        # pipelining overlaps other dispatches with the host merge
        "host_merge_s": merge,
        # merge_s sub-split: native star-POA merge, op-stream decode,
        # host-fallback realignment of band escapes, state glue
        "merge_poa_round_s": prof.get("poa_round_s", 0.0),
        "merge_decode_s": prof.get("decode_s", 0.0),
        "merge_host_fallback_s": prof.get("host_fallback_s", 0.0),
        "merge_state_glue_s": prof.get("stateglue_s", 0.0),
        "host_fallback_items": int(prof.get("host_fallback_items", 0)),
        "host_bound_pct": 100.0 * (disp + merge) / dev_dt,
        "all_runs_s": times,
    }
    ledger["merge_thread_scaling"] = bench_merge_scaling(dev, windows, cfg)
    ledger["kernel_640x128"] = bench_kernel_cells()
    ledger["align_stage_long_synth"] = bench_align_stage_long(cfg)

    # sanity: consensus quality comparable between paths
    from raconx.native import bindings
    d_dev = bindings.edit_distance(b"".join(dev_cons), true.tobytes())
    d_cpu = bindings.edit_distance(b"".join(cpu_cons), true.tobytes())
    ledger["quality"] = {"dataset": "bench synthetic workload "
                         f"({windows.num_windows} windows, err={ERR}); "
                         "golden-dataset numbers live in docs/PARITY.md",
                         "edit_vs_truth_device": int(d_dev),
                         "edit_vs_truth_host": int(d_cpu)}
    _write_ledger(ledger)
    sys.stderr.write("[bench] ledger -> BENCH_LEDGER.json: "
                     + json.dumps(ledger) + "\n")
    print(json.dumps({"metric": "poa_windows_per_s",
                      "value": dev_wps, "unit": "windows/s",
                      "vs_baseline": dev_wps / cpu_wps,
                      "device": stamp}))


def _write_ledger(ledger):
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "BENCH_LEDGER.json")
    with open(path, "w") as f:
        json.dump(ledger, f, indent=1)


if __name__ == "__main__":
    main()
