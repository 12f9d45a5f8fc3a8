#!/usr/bin/env python
"""Hand-written CUDA kernels vs XLA's compile of their plain jnp twins.

Two levels, each run in the order kernel, XLA, XLA, kernel so drift on the
card shows up as a spread:
  --sweeps   device time of each sweep alone, each walk alone, and the
             fused dispatch (unpack + sweep + walk) at real tiers and full
             chunk batches: host clock around block_until_ready, min of
             --reps.
  --stages   the device stages end to end on a genome_scale dataset
             (initialize = align stage, polish = consensus stage) with
             kernels=True vs kernels=False, warm (compiled) runs.

Prints one JSON object per measurement; every line carries the device
stamp (platform, kind, count, card name and power limit).

    python benchmarks/kernel_ab.py --sweeps --stages --genome-mb 1
"""

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _best(fn, reps):
    import jax

    jax.block_until_ready(fn())  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def sweeps(stamp, reps):
    import jax
    import jax.numpy as jnp

    import chip_smoke
    from raconx.ops import cuda_kernels
    from raconx.ops.device_align import _chunk_size as align_chunk
    from raconx.ops.device_consensus import _chunk_size as cons_chunk
    from raconx.ops.myers_kernel import (align_walk_myers_batch,
                                         myers_sweep_ref, myers_walk_ref)
    from raconx.ops.nw_kernel import (align_walk_batch, nw_band_batch_ref,
                                      pack_codes4, pack_delbits,
                                      walk_moves_device, walk_steps)

    rng = np.random.default_rng(3)
    kw = dict(match=3, mismatch=-5, gap=-4)
    for cap, band in ((640, 128), (1280, 256), (10240, 2048)):
        B = cons_chunk(cap, band)
        q8, t8, m, n = chip_smoke._pairs(rng, B, cap, 0.12)
        dc = np.full((B, cap), -4, np.int32)
        gc = jnp.asarray(np.pad(np.cumsum(dc, 1), ((0, 0), (1, 0))))
        q8d, t8d = jnp.asarray(q8), jnp.asarray(t8)
        packed = [jax.device_put(x) for x in (
            pack_codes4(q8), pack_codes4(t8),
            pack_delbits(dc.astype(np.int8)), m, n)]
        ref = jax.jit(lambda q, t, g: nw_band_batch_ref(
            q, t, g, m_cap=cap, n_cap=cap, w_band=band, **kw))
        ker = jax.jit(lambda q, t, g: cuda_kernels.nw_band(
            q, t, g, w_band=band, **kw))
        rec = {"what": "scored", "cap": cap, "band": band, "items": B}
        for name, fn in (("cuda", ker), ("xla", ref), ("xla", ref),
                         ("cuda", ker)):
            rec.setdefault(f"{name}_sweep_s", []).append(
                _best(lambda: fn(q8d, t8d, gc), reps))
        moves = ker(q8d, t8d, gc)[0]
        steps = walk_steps(cap, cap, band)
        walk_ref = jax.jit(lambda mv, m_, n_: walk_moves_device(
            mv, m_, n_, m_cap=cap, n_cap=cap, w_band=band, max_steps=steps,
            packed=True))
        walk_ker = jax.jit(lambda mv, m_, n_: cuda_kernels.nw_walk(
            mv, m_, n_, m_cap=cap, n_cap=cap, w_band=band, max_steps=steps))
        md, nd = jnp.asarray(m), jnp.asarray(n)
        for name, fn in (("cuda", walk_ker), ("xla", walk_ref),
                         ("xla", walk_ref), ("cuda", walk_ker)):
            rec.setdefault(f"{name}_walk_s", []).append(
                _best(lambda: fn(moves, md, nd), reps))
        for name, kernel in (("cuda", True), ("xla", False), ("xla", False),
                             ("cuda", True)):
            rec.setdefault(f"{name}_fused_s", []).append(_best(
                lambda: align_walk_batch(*packed, m_cap=cap, n_cap=cap,
                                         w_band=band, kernel=kernel, **kw),
                reps))
        print(json.dumps({**rec, "device": stamp}), flush=True)
    for cap, band in ((2560, 512), (10240, 1024), (40960, 1024)):
        B = align_chunk(cap, band)
        q8, t8, m, n = chip_smoke._pairs(rng, B, cap, 0.12)
        q8d, t8d = jnp.asarray(q8), jnp.asarray(t8)
        packed = [jax.device_put(x) for x in (pack_codes4(q8),
                                              pack_codes4(t8), m, n)]
        ref = jax.jit(lambda q, t: myers_sweep_ref(q, t, m_cap=cap,
                                                   n_cap=cap, w_band=band))
        ker = jax.jit(lambda q, t: cuda_kernels.myers_sweep(q, t,
                                                            w_band=band))
        rec = {"what": "myers", "cap": cap, "band": band, "items": B}
        for name, fn in (("cuda", ker), ("xla", ref), ("xla", ref),
                         ("cuda", ker)):
            rec.setdefault(f"{name}_sweep_s", []).append(
                _best(lambda: fn(q8d, t8d), reps))
        planes = ker(q8d, t8d)
        walk_ref = jax.jit(lambda p, m_, n_: myers_walk_ref(
            p, m_, n_, m_cap=cap, n_cap=cap, w_band=band)[0])
        walk_ker = jax.jit(lambda p, m_, n_: cuda_kernels.myers_walk(
            p, m_, n_, n_cap=cap))
        md, nd = jnp.asarray(m), jnp.asarray(n)
        for name, fn in (("cuda", walk_ker), ("xla", walk_ref),
                         ("xla", walk_ref), ("cuda", walk_ker)):
            rec.setdefault(f"{name}_walk_s", []).append(
                _best(lambda: fn(planes, md, nd), reps))
        for name, kernel in (("cuda", True), ("xla", False), ("xla", False),
                             ("cuda", True)):
            rec.setdefault(f"{name}_fused_s", []).append(_best(
                lambda: align_walk_myers_batch(*packed, m_cap=cap, n_cap=cap,
                                               w_band=band, kernel=kernel),
                reps))
        print(json.dumps({**rec, "device": stamp}), flush=True)


def stages(stamp, genome_mb, threads):
    import chip_smoke
    from raconx import backends
    from raconx.models.polish_model import PolisherConfig
    from raconx.ops.device_align import DeviceAlignStage
    from raconx.ops.device_consensus import DeviceConsensusStage
    from raconx.polisher import create_polisher

    with tempfile.TemporaryDirectory(prefix="raconx_ab_") as wd:
        chip_smoke.make_data(wd, genome_bp=int(genome_mb * 1e6))
        cfg = PolisherConfig(num_threads=threads)
        outs = {}
        for kernels in (True, False, False, True, True, False):
            backends.get_align_stage = (
                lambda c, k=kernels: DeviceAlignStage(c, kernels=k))
            backends.get_consensus_stage = (
                lambda c, k=kernels: DeviceConsensusStage(c, kernels=k))
            p = create_polisher(os.path.join(wd, "reads.fasta"),
                                os.path.join(wd, "ovl.paf"),
                                os.path.join(wd, "draft.fasta"), cfg)
            with contextlib.redirect_stderr(io.StringIO()):
                t0 = time.perf_counter()
                p.initialize()
                t1 = time.perf_counter()
                out = p.polish(True)
                t2 = time.perf_counter()
            name = "cuda" if kernels else "xla"
            outs.setdefault(name, out)
            assert outs[name] == out
            print(json.dumps({"what": "stages", "genome_mb": genome_mb,
                              "kernels": name, "initialize_s": t1 - t0,
                              "polish_s": t2 - t1, "device": stamp}),
                  flush=True)
        assert outs["cuda"] == outs["xla"], "kernel changed the output"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweeps", action="store_true")
    ap.add_argument("--stages", action="store_true")
    ap.add_argument("--genome-mb", type=float, default=1.0)
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args()
    from raconx.utils.jaxenv import device_stamp, setup_jax

    setup_jax()
    stamp = device_stamp()
    if stamp["platform"] != "gpu":
        sys.exit(f"kernel_ab: needs a GPU, JAX has {stamp}")
    if a.sweeps:
        sweeps(stamp, a.reps)
    if a.stages:
        stages(stamp, a.genome_mb, os.cpu_count() or 4)


if __name__ == "__main__":
    main()
