"""CUDA kernels for the alignment sweeps and walks, called through jax.ffi.

The source (cuda/kernels.cu) is compiled with nvcc for Hopper (sm_90a) the
first time a kernel is traced; the shared object goes to cuda/build/, which
.gitignore lists, and is rebuilt when the source is newer. A file lock
keeps concurrent processes from building at once. These kernels have no
CPU or interpret mode: on other platforms the stages run the plain
jax.numpy twins.

    nw_band(q8, t8, gc, ...)   -> (moves (B, m_cap/16, W) i32, score (B, 1))
    nw_walk(moves, m, n, ...)  -> payload (B, max_steps/4 + 1) u8
    myers_sweep(q8, t8, ...)   -> planes (B, m_cap, 2, W/32) i32
    myers_walk(planes, m, n)   -> payload (B, m_cap + 2) u8

Each returns exactly what its jnp twin returns (nw_band_batch_ref,
walk_moves_device + escape byte, myers_sweep_ref, myers_walk_ref).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np

_HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda")
_SRC = os.path.join(_HERE, "kernels.cu")
_BUILD = os.path.join(_HERE, "build")
_LIB = os.path.join(_BUILD, "libraconx_cuda.so")
ARCH = "arch=compute_90a,code=sm_90a"

# bands each kernel is instantiated for (kernels.cu switch statements)
NW_BANDS = (64, 128, 256, 384, 512, 768, 1024, 2048)
MYERS_BANDS = (64, 128, 256, 512, 1024, 2048, 4096)

_lock = threading.Lock()
_registered = False


def nvcc() -> str:
    """nvcc from CUDA_HOME, then PATH, then the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def build_command(out: str) -> list[str]:
    return [nvcc(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-I", jax.ffi.include_dir(),
            "-o", out, _SRC]


def build() -> str:
    """Compile the kernels if the library is missing or stale; returns its
    path. Raises RuntimeError with nvcc's output on failure."""
    os.makedirs(_BUILD, exist_ok=True)
    with open(os.path.join(_BUILD, ".lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if (os.path.exists(_LIB)
                and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)):
            return _LIB
        tmp = f"{_LIB}.{os.getpid()}.tmp"
        try:
            res = subprocess.run(build_command(tmp), capture_output=True,
                                 text=True, timeout=900)
        except OSError as e:
            raise RuntimeError(f"cannot run nvcc: {e}") from e
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{res.stderr[-4000:]}")
        os.replace(tmp, _LIB)
    return _LIB


def load() -> None:
    """Build (if needed), load and register the FFI targets once."""
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.CDLL(build())
        for name, sym in (("raconx_nw_band", lib.RaconxNwBand),
                          ("raconx_myers_sweep", lib.RaconxMyersSweep),
                          ("raconx_nw_walk", lib.RaconxNwWalk),
                          ("raconx_myers_walk", lib.RaconxMyersWalk)):
            jax.ffi.register_ffi_target(name, jax.ffi.pycapsule(sym),
                                        platform="CUDA")
        _registered = True


def nw_band(q8, t8, gc, *, w_band, match, mismatch, gap):
    """Scored banded NW sweep: the CUDA twin of nw_band_batch_ref.
    q8 (B, m_cap) / t8 (B, n_cap) int8 codes, gc (B, n_cap+1) int32
    cumulative deletion costs."""
    if w_band not in NW_BANDS:
        raise ValueError(f"no CUDA scored sweep for band {w_band}")
    load()
    B, m_cap = q8.shape
    out = (jax.ShapeDtypeStruct((B, m_cap // 16, w_band), jnp.int32),
           jax.ShapeDtypeStruct((B, 1), jnp.int32))
    return jax.ffi.ffi_call("raconx_nw_band", out)(
        q8.astype(jnp.int8), t8.astype(jnp.int8), gc.astype(jnp.int32),
        w_band=np.int32(w_band), match=np.int32(match),
        mismatch=np.int32(mismatch), gap=np.int32(gap))


def myers_sweep(q8, t8, *, w_band):
    """Myers bit-vector sweep: the CUDA twin of myers_sweep_ref.
    q8/t8 (B, cap) int8 codes with equal caps."""
    if w_band not in MYERS_BANDS:
        raise ValueError(f"no CUDA Myers sweep for band {w_band}")
    load()
    B, m_cap = q8.shape
    out = jax.ShapeDtypeStruct((B, m_cap, 2, w_band // 32), jnp.int32)
    return jax.ffi.ffi_call("raconx_myers_sweep", out)(
        q8.astype(jnp.int8), t8.astype(jnp.int8), w_band=np.int32(w_band))


def nw_walk(moves, m, n, *, m_cap, n_cap, w_band, max_steps):
    """Scored traceback: the CUDA twin of walk_moves_device(packed=True)
    with the escape flag appended as the last payload byte."""
    load()
    B = moves.shape[0]
    out = jax.ShapeDtypeStruct((B, max_steps // 4 + 1), jnp.uint8)
    return jax.ffi.ffi_call("raconx_nw_walk", out)(
        moves, m.astype(jnp.int32), n.astype(jnp.int32),
        m_cap=np.int32(m_cap), n_cap=np.int32(n_cap),
        w_band=np.int32(w_band), max_steps=np.int32(max_steps))


def myers_walk(planes, m, n, *, n_cap):
    """Myers traceback: the CUDA twin of myers_walk_ref's payload."""
    load()
    B, m_cap = planes.shape[:2]
    out = jax.ShapeDtypeStruct((B, m_cap + 2), jnp.uint8)
    return jax.ffi.ffi_call("raconx_myers_walk", out)(
        planes, m.astype(jnp.int32), n.astype(jnp.int32),
        n_cap=np.int32(n_cap))
