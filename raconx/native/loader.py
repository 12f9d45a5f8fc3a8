"""Build-on-demand loader for the native C++ runtime (libracon_host.so).

The library is compiled from raconx/native/src with g++ the first time it
is needed; the shared object is cached next to the sources. No pybind11: the
C API is consumed through ctypes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src")
_LIB = os.path.join(_HERE, "libracon_host.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _sources() -> list[str]:
    if not os.path.isdir(_SRC):
        return []
    return sorted(
        os.path.join(_SRC, f) for f in os.listdir(_SRC) if f.endswith(".cpp"))


def _needs_build(sources: list[str]) -> bool:
    if not os.path.exists(_LIB):
        return True
    lib_mtime = os.path.getmtime(_LIB)
    return any(os.path.getmtime(s) > lib_mtime for s in sources)


def build(verbose: bool = False) -> bool:
    sources = _sources()
    if not sources:
        return False
    if not _needs_build(sources):
        return True
    # extra flags, e.g. RACONX_NATIVE_CXXFLAGS="-fsanitize=address -g"
    # for sanitizer builds (the reference's `make debug` ASan role;
    # run python under LD_PRELOAD=libasan.so for ctypes loading)
    extra = os.environ.get("RACONX_NATIVE_CXXFLAGS", "").split()
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           "-pthread", *extra, "-o", _LIB + ".tmp", *sources, "-lz"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    except (OSError, subprocess.TimeoutExpired) as e:
        sys.stderr.write(f"[raconx::native] build failed: {e}\n")
        return False
    if res.returncode != 0:
        sys.stderr.write(f"[raconx::native] build failed:\n{res.stderr}\n")
        return False
    os.replace(_LIB + ".tmp", _LIB)
    if verbose:
        sys.stderr.write(f"[raconx::native] built {_LIB}\n")
    return True


def get() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _lib is not None:
            return _lib
        if _tried:
            return None
        _tried = True
        if not build():
            return None
        try:
            _lib = ctypes.CDLL(_LIB)
        except OSError as e:
            sys.stderr.write(f"[raconx::native] load failed: {e}\n")
            return None
        return _lib


def available() -> bool:
    return get() is not None
