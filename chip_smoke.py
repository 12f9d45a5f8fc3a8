#!/usr/bin/env python
"""Smoke test of raconx on an NVIDIA GPU: does the polish path run on the
card, through the CLI, and give the right bytes?

    python chip_smoke.py            # one card: device, kernel, e2e phases
    python chip_smoke.py --mesh 4   # four cards: mesh vs one-card e2e only

Phases (any failure exits non-zero; nothing is caught and ignored):
  device  the card's name and power limit (nvidia-smi) and jax.devices();
          fails unless JAX's platform is gpu.
  kernels each CUDA kernel (two sweeps, two walks) against its plain
          jax.numpy twin under XLA on the card, once per real tier at a
          full chunk batch, plus the op lists against the native C++
          aligner's. Tolerance zero:
          every value is an integer and no matrix product is involved.
          Prints compiled.memory_analysis() for each program.
  e2e     a 4.6 Mb genome (E. coli K-12 size), 20x coverage of 8 kb reads
          at 12% ONT-like error, PAF overlaps without CIGARs (so the align
          stage runs too), polished through raconx.cli.main with
          --backend gpu and --backend native: the FASTA must be
          byte-identical, and both device stages must have sent items to
          the card.
  mesh    (--mesh N only) the same dataset polished with an N-card mesh and
          with one card: byte-identical FASTA.

The last line of stdout is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

import raconx  # noqa: F401  (fails at once outside a checkout)

GENOME_BP = 4_600_000
COVERAGE = 20
READ_LEN = 8000
READ_ERR = 0.12


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- device


def device_phase(expect: str = "gpu"):
    """Print the card line and the devices; raise unless the platform is
    `expect`. Returns jax.devices()."""
    import jax

    from raconx.utils.jaxenv import card_info, setup_jax

    setup_jax()
    devices = jax.devices()
    if devices[0].platform != expect:
        raise SystemExit(f"chip_smoke: JAX platform is "
                         f"{devices[0].platform!r}, not {expect!r}")
    card = card_info()
    for line in card.splitlines():
        log(line)
    log(f"jax.devices(): {devices}")
    return devices


# ---------------------------------------------------------------- kernels


def _pairs(rng, batch, cap, err):
    """Realistic alignment pairs: a target of ~3/4 cap and a query copied
    from it with err substitutions and balanced indels."""
    q8 = np.full((batch, cap), 5, np.int8)
    t8 = np.full((batch, cap), 5, np.int8)
    m = np.zeros(batch, np.int32)
    n = np.zeros(batch, np.int32)
    for b in range(batch):
        tlen = int(rng.integers(cap // 2, cap * 3 // 4))
        t = rng.integers(0, 4, tlen).astype(np.int8)
        u = rng.random(tlen)
        q = t.copy()
        q[u < err / 3] = rng.integers(0, 4, int((u < err / 3).sum()))
        keep = (u >= err / 3) & (u < 2 * err / 3)
        q = np.delete(q, np.flatnonzero(keep))
        ins = np.flatnonzero(rng.random(len(q)) < err / 3)
        q = np.insert(q, ins, rng.integers(0, 4, len(ins)).astype(np.int8))
        q = q[:cap]
        q8[b, : len(q)] = q
        t8[b, :tlen] = t
        m[b], n[b] = len(q), tlen
    return q8, t8, m, n


def _blob(codes, lens):
    """(offsets, bases) of the real parts of a padded code batch, as the
    native aligner takes them."""
    from raconx.ops.nw_kernel import _DECODE

    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    return off, _DECODE[np.concatenate([codes[b, :k]
                                        for b, k in enumerate(lens)])]


def _compiled(fn, *args, label: str):
    import jax

    c = jax.jit(fn).lower(*args).compile()
    log(f"  {label} memory_analysis: {c.memory_analysis()}")
    return c


def _decode_and_check(label, ops_fn, payload, m, n, host_ops):
    """Op lists from a device payload vs the native aligner's."""
    payload = np.asarray(payload)
    esc = payload[:, -1] != 0
    ops, off, cnt = ops_fn(payload, m, n)
    hops, hoff, hcnt = host_ops
    bad = [b for b in np.flatnonzero(~esc)
           if not np.array_equal(ops[off[b] : off[b] + cnt[b]],
                                 hops[hoff[b] : hoff[b] + hcnt[b]])]
    if bad:
        raise AssertionError(f"{label}: {len(bad)} op lists differ from "
                             f"the native aligner (first item {bad[0]})")
    return int(esc.sum())


def kernel_phase(nw_tiers, myers_tiers, batch=None, kernel=True, seed=7):
    """Each kernel vs its jnp twin on the card at every tier. `batch`
    overrides the full chunk batch (tests); kernel=False runs the twin on
    both sides, which checks only the comparison itself."""
    import jax.numpy as jnp

    from raconx.native import bindings
    from raconx.ops import cuda_kernels
    from raconx.ops.device_align import _chunk_size as align_chunk
    from raconx.ops.device_consensus import _chunk_size as cons_chunk
    from raconx.ops.myers_kernel import (myers_sweep_ref, myers_walk_ref,
                                         rows_payload_width)
    from raconx.ops.nw_kernel import (nw_band_batch_ref, walk_moves_device,
                                      walk_steps)

    rng = np.random.default_rng(seed)
    thr = os.cpu_count() or 4
    match, mismatch, gap = 3, -5, -4
    for cap, band in nw_tiers:
        B = batch or cons_chunk(cap, band)
        q8, t8, m, n = _pairs(rng, B, cap, READ_ERR)
        dc = np.where(rng.random((B, cap)) < 0.2, 0, gap).astype(np.int32)
        gc = np.zeros((B, cap + 1), np.int32)
        gc[:, 1:] = np.cumsum(dc, axis=1)
        kw = dict(match=match, mismatch=mismatch, gap=gap)
        ref = _compiled(lambda q, t, g: nw_band_batch_ref(
            q, t, g, m_cap=cap, n_cap=cap, w_band=band, **kw), q8, t8, gc,
            label=f"nw ref {cap}/{band} x{B}")
        if kernel:
            ker = _compiled(lambda q, t, g: cuda_kernels.nw_band(
                q, t, g, w_band=band, **kw), q8, t8, gc,
                label=f"nw cuda {cap}/{band} x{B}")
        else:
            ker = ref
        t0 = time.perf_counter()
        mv_k, sc_k = [np.asarray(x) for x in ker(q8, t8, gc)]
        t_k = time.perf_counter() - t0
        mv_r, sc_r = [np.asarray(x) for x in ref(q8, t8, gc)]
        if not (np.array_equal(mv_k, mv_r) and np.array_equal(sc_k, sc_r)):
            raise AssertionError(f"nw {cap}/{band}: kernel moves/scores "
                                 "differ from the jnp reference")
        steps = walk_steps(cap, cap, band)
        codes, esc = walk_moves_device(jnp.asarray(mv_k), m, n, m_cap=cap,
                                       n_cap=cap, w_band=band,
                                       max_steps=steps, packed=True)
        payload = np.concatenate([np.asarray(codes),
                                  np.asarray(esc)[:, None]], axis=1)
        if kernel:
            walk = _compiled(lambda mv, m_, n_: cuda_kernels.nw_walk(
                mv, m_, n_, m_cap=cap, n_cap=cap, w_band=band,
                max_steps=steps), mv_k, m, n,
                label=f"nw walk cuda {cap}/{band} x{B}")
            if not np.array_equal(np.asarray(walk(mv_k, m, n)), payload):
                raise AssertionError(f"nw {cap}/{band}: CUDA walk payload "
                                     "differs from the jnp walk")
        qoff, qblob = _blob(q8, m)
        toff, tblob = _blob(t8, n)
        host = bindings.align_batch_percol(
            qblob, qoff, tblob, toff,
            np.concatenate([dc[b, : n[b]] for b in range(B)]),
            match, mismatch, gap, thr)
        n_esc = _decode_and_check(
            f"nw {cap}/{band}",
            lambda p, m_, n_: bindings.opstream_packed_to_ops_batch(
                np.ascontiguousarray(p[:, :-1]), steps, m_, n_, thr),
            payload, m, n, host)
        log(f"  nw {cap}/{band} x{B}: moves+scores equal, walk payloads "
            f"equal, op lists equal "
            f"({n_esc} band escapes), first call {t_k:.4f}s incl. copies")
    for cap, band in myers_tiers:
        B = batch or align_chunk(cap, band)
        q8, t8, m, n = _pairs(rng, B, cap, READ_ERR)
        ref = _compiled(lambda q, t: myers_sweep_ref(
            q, t, m_cap=cap, n_cap=cap, w_band=band), q8, t8,
            label=f"myers ref {cap}/{band} x{B}")
        if kernel:
            ker = _compiled(lambda q, t: cuda_kernels.myers_sweep(
                q, t, w_band=band), q8, t8,
                label=f"myers cuda {cap}/{band} x{B}")
        else:
            ker = ref
        t0 = time.perf_counter()
        pl_k = np.asarray(ker(q8, t8))
        t_k = time.perf_counter() - t0
        if not np.array_equal(pl_k, np.asarray(ref(q8, t8))):
            raise AssertionError(f"myers {cap}/{band}: kernel planes differ "
                                 "from the jnp reference")
        payload, _ = myers_walk_ref(jnp.asarray(pl_k), m, n, m_cap=cap,
                                    n_cap=cap, w_band=band)
        payload = np.asarray(payload)
        if kernel:
            walk = _compiled(lambda p, m_, n_: cuda_kernels.myers_walk(
                p, m_, n_, n_cap=cap), pl_k, m, n,
                label=f"myers walk cuda {cap}/{band} x{B}")
            if not np.array_equal(np.asarray(walk(pl_k, m, n)), payload):
                raise AssertionError(f"myers {cap}/{band}: CUDA walk payload "
                                     "differs from the jnp walk")
        qoff, qblob = _blob(q8, m)
        toff, tblob = _blob(t8, n)
        host = bindings.align_batch(qblob, qoff, tblob, toff, 0, -1, -1,
                                    True, thr)
        n_esc = _decode_and_check(
            f"myers {cap}/{band}",
            lambda p, m_, n_: bindings.opstream_rows_to_ops_batch(
                p, rows_payload_width(cap), m_, n_, thr),
            payload, m, n, host)
        log(f"  myers {cap}/{band} x{B}: planes equal, walk payloads equal, "
            f"op lists equal "
            f"({n_esc} band escapes), first call {t_k:.4f}s incl. copies")


# ---------------------------------------------------------------- e2e


def make_data(workdir, genome_bp=GENOME_BP, coverage=COVERAGE,
              read_len=READ_LEN, err=READ_ERR):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from benchmarks.genome_scale import make_dataset

    t0 = time.perf_counter()
    true = make_dataset(workdir, genome_bp, read_len, coverage, err)
    log(f"dataset: {genome_bp} bp genome, {coverage}x {read_len} bp reads, "
        f"{err:.0%} error, PAF without CIGARs "
        f"({time.perf_counter() - t0:.1f}s to generate)")
    return true


def polish(workdir, backend, threads):
    """One raconx.cli.main run; returns (fasta bytes, stages, init_s,
    polish_s). The stages the run built are recorded (for their
    counters) by wrapping the backend registry's factories."""
    from raconx import backends, cli
    from raconx.polisher import Polisher

    made, times = [], {}
    factories = {k: getattr(backends, k)
                 for k in ("get_align_stage", "get_consensus_stage")}
    methods = {k: getattr(Polisher, k) for k in ("initialize", "polish")}

    def record(factory):
        def wrapped(cfg):
            made.append(factory(cfg))
            return made[-1]
        return wrapped

    def timed(name, method):
        def wrapped(self, *a, **k):
            t0 = time.perf_counter()
            try:
                return method(self, *a, **k)
            finally:
                times[name] = time.perf_counter() - t0
        return wrapped

    out = io.TextIOWrapper(io.BytesIO())
    err = io.StringIO()
    try:
        for k, f in factories.items():
            setattr(backends, k, record(f))
        for k, f in methods.items():
            setattr(Polisher, k, timed(k, f))
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(["--backend", backend, "-t", str(threads),
                           os.path.join(workdir, "reads.fasta"),
                           os.path.join(workdir, "ovl.paf"),
                           os.path.join(workdir, "draft.fasta")])
    finally:
        for k, f in factories.items():
            setattr(backends, k, f)
        for k, f in methods.items():
            setattr(Polisher, k, f)
    if rc != 0:
        raise RuntimeError(f"raconx --backend {backend} exited {rc}:\n"
                           + err.getvalue()[-3000:])
    out.flush()
    return (out.buffer.getvalue(), made, times.get("initialize", 0.0),
            times.get("polish", 0.0))


def stage_counters(stages) -> dict:
    out = {}
    for st in stages:
        s = getattr(st, "stats", None)
        if s is None:
            continue
        out[type(st).__name__] = {
            "device_items": s["device_items"],
            "host_fallback_items": s["host_items"],
            "tiers": {f"{c}/{b}": k for (c, b), k in
                      sorted(s["tiers"].items())}}
    return out


def e2e_phase(workdir, true, threads):
    from raconx.native import bindings

    runs = {}
    for backend in ("gpu", "native"):
        fasta, stages, t_init, t_pol = polish(workdir, backend, threads)
        runs[backend] = fasta
        log(f"--backend {backend}: initialize {t_init:.2f}s, polish "
            f"{t_pol:.2f}s, {len(fasta)} FASTA bytes")
        if backend == "gpu":
            counters = stage_counters(stages)
            log(f"  stage counters: {json.dumps(counters)}")
            for name in ("DeviceAlignStage", "DeviceConsensusStage"):
                if counters.get(name, {}).get("device_items", 0) == 0:
                    raise AssertionError(f"{name} sent no items to the "
                                         "device")
    if runs["gpu"] != runs["native"]:
        a, b = runs["gpu"], runs["native"]
        first = next((i for i in range(min(len(a), len(b))) if a[i] != b[i]),
                     min(len(a), len(b)))
        raise AssertionError(f"gpu and native FASTA differ (lengths "
                             f"{len(a)} vs {len(b)}, first byte {first})")
    polished = runs["gpu"].split(b"\n", 1)[1].replace(b"\n", b"")
    t0 = time.perf_counter()
    d = bindings.edit_distance(polished, true.tobytes())
    log(f"gpu and native FASTA byte-identical; identity vs truth "
        f"{100.0 * (1 - d / len(true)):.4f}% for both (edit distance {d}, "
        f"{time.perf_counter() - t0:.1f}s to compute)")


def mesh_phase(workdir, n_devices, threads):
    """The same polish with an n-card mesh and with one card."""
    import jax

    from raconx.parallel import mesh as mesh_mod

    if len(jax.devices()) < n_devices:
        raise SystemExit(f"chip_smoke: --mesh {n_devices} needs "
                         f"{n_devices} devices, JAX has {len(jax.devices())}")
    runs = {}
    try:
        for label, m in (("mesh", mesh_mod.window_mesh(
                jax.devices()[:n_devices])), ("one card", None)):
            mesh_mod.set_active_mesh(m)
            fasta, stages, t_init, t_pol = polish(workdir, "gpu", threads)
            runs[label] = fasta
            log(f"{label}: initialize {t_init:.2f}s, polish {t_pol:.2f}s, "
                f"counters {json.dumps(stage_counters(stages))}")
    finally:
        mesh_mod.clear_active_mesh()
    if runs["mesh"] != runs["one card"]:
        raise AssertionError(f"{n_devices}-card mesh FASTA differs from "
                             "the one-card FASTA")
    log(f"{n_devices}-card mesh and one-card FASTA byte-identical "
        f"({len(runs['mesh'])} bytes)")


# ---------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="run only the N-card mesh-vs-one-card e2e check")
    a = ap.parse_args(argv)
    t_start = time.perf_counter()
    devices = device_phase("gpu")
    threads = os.cpu_count() or 4
    with tempfile.TemporaryDirectory(prefix="raconx_smoke_") as wd:
        if a.mesh:
            true = make_data(wd)
            mesh_phase(wd, a.mesh, threads)
        else:
            from raconx.ops.device_align import _TIERS as ALIGN_TIERS
            from raconx.ops.device_consensus import _TIERS as CONS_TIERS

            log("kernel phase:")
            kernel_phase(CONS_TIERS, ALIGN_TIERS)
            true = make_data(wd)
            e2e_phase(wd, true, threads)
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f}s")
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
