"""JAX process-level setup shared by the device stages.

The CLI is a batch tool (one process per run, reference: src/main.cpp), so
without a persistent compilation cache every run would re-pay XLA
compilation of the stage programs. The cache keys on program + compile
options, and the stages' canonical (cap, band) tiers keep the program set
small and stable across inputs.

Where the cache lives: JAX_COMPILATION_CACHE_DIR when it is set (JAX reads
it itself; nothing here overrides it), else a fixed directory inside the
checkout (CACHE_DIR, listed in .gitignore) — fixed, because the path is
part of the cache's key.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")

_done = False


def setup_jax() -> None:
    global _done
    if _done:
        return
    _done = True
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    os.makedirs(CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)


def card_info() -> str:
    """The cards' names and power limits as nvidia-smi reports them (one
    line per card), or "" where nvidia-smi is missing."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return ""


def device_stamp() -> dict:
    """Where a measurement ran: JAX's platform, device kind and device
    count, plus the card name and power limit on GPUs."""
    import jax

    d = jax.devices()[0]
    out = {"platform": d.platform, "kind": d.device_kind,
           "count": len(jax.devices())}
    if d.platform == "gpu":
        out["card"] = card_info()
    return out
