"""Backend registry: gpu (device stages) > native (C++) > python (oracle).

"gpu" runs the alignment sweeps on the card (CUDA kernels, XLA for the
rest) with the native runtime doing the graph merge; it needs a GPU that
JAX can see. "auto" picks gpu when there is one and native otherwise, and
says so on stderr; a device stage that cannot be built on a machine with a
GPU is an error, never a silent fallback.
"""

from __future__ import annotations

import sys

import numpy as np

from .core.breakpoints import breaking_points_from_ops
from .errors import RaconError
from .models.polish_model import PolisherConfig
from .ops import nw_host, poa_host

BACKENDS = ("auto", "gpu", "native", "python")

_notes: set = set()


def _note(msg: str) -> None:
    if msg not in _notes:
        _notes.add(msg)
        sys.stderr.write(f"[racon::] {msg}\n")


def gpu_present() -> bool:
    from .utils.jaxenv import setup_jax

    setup_jax()
    import jax

    return jax.default_backend() == "gpu"


def use_device(cfg: PolisherConfig) -> bool:
    """Whether cfg's stages run on the GPU. Raises RaconError for an
    unknown backend, for --backend gpu without a GPU, and when a GPU is
    present but the device stages cannot run (no native runtime)."""
    if cfg.backend not in BACKENDS:
        raise RaconError(f"[racon::] error: unknown backend {cfg.backend!r} "
                         f"(choose one of {', '.join(BACKENDS)})!")
    if cfg.backend in ("native", "python"):
        return False
    if not gpu_present():
        if cfg.backend == "gpu":
            raise RaconError("[racon::] error: --backend gpu requested but "
                             "JAX finds no GPU!")
        _note("no GPU found: using the native host path")
        return False
    from .native import loader

    if not loader.available():
        raise RaconError("[racon::] error: the GPU backend needs the native "
                         "runtime (graph merge), which failed to build!")
    return True


def get_align_stage(cfg: PolisherConfig):
    if use_device(cfg):
        from .ops.device_align import DeviceAlignStage

        return DeviceAlignStage(cfg, kernels=True)
    return _host_align_stage(cfg)


def get_consensus_stage(cfg: PolisherConfig):
    if use_device(cfg):
        from .ops.device_consensus import (DeviceConsensusStage,
                                           device_scores_ok)

        if device_scores_ok(cfg):
            return DeviceConsensusStage(cfg, kernels=True)
        if cfg.backend == "gpu":
            raise RaconError("[racon::] error: scores outside [-120, 120] "
                             "are not supported on the GPU backend!")
        _note("scores outside [-120, 120]: consensus runs on the native "
              "host path")
    return _host_consensus_stage(cfg)


def _host_align_stage(cfg: PolisherConfig):
    if cfg.backend != "python":
        from .native import loader

        if loader.available():
            from .native.align_stage import NativeAlignStage

            return NativeAlignStage(cfg)
        if cfg.backend == "native":
            raise RuntimeError("native align backend requested but "
                               "unavailable")
    return PyAlignStage(cfg)


def _host_consensus_stage(cfg: PolisherConfig):
    if cfg.backend != "python":
        from .native import loader

        if loader.available():
            from .native.consensus_stage import NativeConsensusStage

            return NativeConsensusStage(cfg)
        if cfg.backend == "native":
            raise RuntimeError("native consensus backend requested but "
                               "unavailable")
    return PyConsensusStage(cfg)


# ---------------------------------------------------------------------- #
# python oracle stages
# ---------------------------------------------------------------------- #


class PyAlignStage:
    """Edit-distance NW on host numpy; emits breaking points by walking the
    op list (reference edlib role, src/overlap.cpp:192-224)."""

    def __init__(self, cfg: PolisherConfig):
        self.cfg = cfg

    def breaking_points(self, overlaps, indices, sequences, window_length,
                        logger) -> list[np.ndarray]:
        # the oracle is full-matrix O(m*n) per overlap: real datasets take
        # hours. Warn instead of silently hanging (use native/gpu for speed)
        cells = sum(
            (int(overlaps.q_end[i]) - int(overlaps.q_begin[i]))
            * (int(overlaps.t_end[i]) - int(overlaps.t_begin[i]))
            for i in indices)
        if cells > 2 * 10**9:
            sys.stderr.write(
                "[racon::] warning: python oracle backend selected for "
                f"{len(indices)} overlaps (~{cells / 1e9:.1f}G DP cells); "
                "this may take hours — use --backend native or gpu\n")
        out = []
        step = max(1, len(indices) // 20)
        for k, i in enumerate(indices):
            qid = int(overlaps.q_id[i])
            strand = bool(overlaps.strand[i])
            q_begin = int(overlaps.q_begin[i])
            q_end = int(overlaps.q_end[i])
            q_length = int(overlaps.q_length[i])
            t_begin = int(overlaps.t_begin[i])
            t_end = int(overlaps.t_end[i])
            if strand:
                src = sequences.reverse_complement(qid)
                q = src[q_length - q_end : q_length - q_begin]
            else:
                q = sequences.data(qid)[q_begin:q_end]
            t = sequences.data(int(overlaps.t_id[i]))[t_begin:t_end]
            _, ops = nw_host.nw_align(q, t, 0, -1, -1)
            out.append(breaking_points_from_ops(
                ops, strand, q_begin, q_end, q_length, t_begin, t_end,
                window_length))
            if (k + 1) % step == 0:
                logger.bar("[racon::Polisher::initialize] aligning overlaps")
        return out


class PyConsensusStage:
    def __init__(self, cfg: PolisherConfig):
        self.cfg = cfg

    def consensus_windows(self, windows, cfg: PolisherConfig, logger):
        from .core.windows import WINDOW_TYPE_TGS
        consensus: list[bytes] = []
        polished: list[bool] = []
        tgs = windows.window_type == WINDOW_TYPE_TGS
        if len(windows.lay_win) > 50_000:
            sys.stderr.write(
                "[racon::] warning: python oracle backend selected for "
                f"{windows.num_windows} windows / {windows.num_layers} "
                "layers; this may take hours — use --backend native or gpu\n")
        step = max(1, windows.num_windows // 20)
        for wi in range(windows.num_windows):
            layers = []
            for li in windows.layer_indices(wi):
                layers.append((windows.layer_data(int(li)),
                               windows.layer_quality(int(li)),
                               int(windows.lay_begin[li]),
                               int(windows.lay_end[li])))
            cons, ok = poa_host.consensus_window(
                windows.backbone(wi), windows.backbone_quality(wi), layers,
                tgs, cfg.trim, cfg.match, cfg.mismatch, cfg.gap,
                window_id=int(windows.win_target[wi]),
                rank=int(windows.win_rank[wi]), passes=cfg.refine_passes,
                cand_frac=cfg.candidate_frac, cand_min=cfg.candidate_min)
            consensus.append(cons)
            polished.append(ok)
            if (wi + 1) % step == 0:
                logger.bar("[racon::Polisher::polish] generating consensus")
        return consensus, polished
