"""Background device->host payload prefetch shared by the device stages.

A blocking payload fetch (np.asarray on a jax array) waits for the device
program and the copy. Submitting the fetch to a small worker pool right
after dispatch lets those waits overlap each other, the device compute,
and the host merge/decode: the workers block in np.asarray with the GIL
released.

This is the role the reference's producer/consumer batch overlap plays
for its CUDA batches (src/cuda/cudapolisher.cpp:83-144,254-333), done
the host-runtime way: the device work is already async under jax; only
the host-side drain needed unserializing.

RACONX_FETCH_THREADS sizes the pool (default 4; 0 disables prefetch —
fetches then block inline at drain time).
"""

from __future__ import annotations

import os

import numpy as np

_pool = None


def submit(payload):
    """Start pulling `payload` to host on a worker thread. Returns a
    Future, or None when prefetch is disabled (caller then fetches
    inline with np.asarray)."""
    global _pool
    try:
        n = int(os.environ.get("RACONX_FETCH_THREADS", 4))
    except ValueError:
        n = 4
    if n <= 0:
        return None
    if _pool is None:
        import concurrent.futures

        _pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(2, min(n, 8)),
            thread_name_prefix="racon-fetch")
    return _pool.submit(np.asarray, payload)


def resolve(payload, fut) -> np.ndarray:
    """The host copy of a dispatched payload: the prefetched result when
    a worker pulled it, else a blocking inline fetch."""
    return fut.result() if fut is not None else np.asarray(payload)
