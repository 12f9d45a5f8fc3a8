"""Multi-device scale-out: window/overlap batches sharded over a device mesh.

The reference's only parallelism is one process's thread pool plus optional
multi-GPU batch queues (SURVEY.md sec 2.3). Here the unit of distribution is
the same as the device batch: padded alignment items (window layers or
overlap slices). They are embarrassingly parallel, so the mapping is a 1-D
mesh over the process's devices with the batch dimension sharded: each
device runs the single-device program on its slice, with no collectives in
the hot loop. The cards of a host are joined all to all, so the mesh
follows the batch alone.

Multi-process runs (parallel/dist.py) shard the work per process first;
each process's mesh spans its LOCAL devices only.
"""

from __future__ import annotations

import functools
import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def window_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices; axis "win" shards batches."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices, axis_names=("win",))


_active_mesh_cache: list = []


def set_active_mesh(mesh: "Mesh | None") -> None:
    """Pin the stage-dispatch mesh for this process (None = single
    device) — for harnesses that compare a mesh run with a one-device
    run of the same stage."""
    _active_mesh_cache.clear()
    _active_mesh_cache.append(mesh)


def clear_active_mesh() -> None:
    """Drop the pinned/derived mesh so the next active_mesh() re-derives
    it from the current device topology."""
    _active_mesh_cache.clear()


def active_mesh() -> Mesh | None:
    """Mesh over this process's devices when more than one is present (the
    stages shard their batches over it); None with one device. Under
    jax.distributed the mesh spans LOCAL devices only: work is already
    sharded per process by parallel/dist.py. RACONX_MESH=0 disables."""
    if _active_mesh_cache:
        return _active_mesh_cache[0]
    mesh = None
    if os.environ.get("RACONX_MESH", "1") != "0":
        devices = (jax.local_devices() if jax.process_count() > 1
                   else jax.devices())
        if len(devices) > 1:
            mesh = window_mesh(devices)
    _active_mesh_cache.append(mesh)
    return mesh


@functools.lru_cache(maxsize=None)
def _sharded(mesh: Mesh, core, n_args: int, kw: tuple):
    local = functools.partial(core, **dict(kw))
    return jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(P("win"),) * n_args,
        out_specs=(P("win"), P("win")), check_vma=False))


def sharded_align_walk(mesh: Mesh, core, arrays, **kw):
    """Run a fused align+walk core (nw_kernel.align_walk_core or
    myers_kernel.align_walk_myers_core) with every input's batch dimension
    sharded over the mesh: each device runs the single-device program on
    its slice. The host arrays go straight to their shards (no staging on
    device 0); the batch must be a multiple of the mesh size
    (nw_kernel.padded_batch arranges it)."""
    shard = NamedSharding(mesh, P("win"))
    arrays = [jax.device_put(np.asarray(a), shard) for a in arrays]
    fn = _sharded(mesh, core, len(arrays), tuple(sorted(kw.items())))
    return fn(*arrays)
