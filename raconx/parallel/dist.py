"""Multi-process distribution: per-process work shards + gathers.

The reference's multi-GPU batch dispatch (one process, one batch queue per
GPU — src/cuda/cudapolisher.cpp:165-180) generalizes here to multi-process
jax: every process parses the full input (IO is cheap next to alignment and
consensus), aligns a contiguous shard of the overlaps, all-gathers the
breaking points, builds the full window set, polishes a contiguous shard of
the windows, and gathers consensus bytes to process 0, which stitches and
prints (SURVEY.md §5.8's mapping).

Entry points:
  initialize()        -- jax.distributed.initialize (env-driven or explicit)
  is_active()         -- more than one jax process
  shard_range(n)      -- this process's contiguous [lo, hi) of n work items
  allgather_blob(...) -- variable-length per-process arrays -> full list

On GPUs the collectives ride NCCL; on CPU (tests) they need gloo: run each
process with JAX_CPU_COLLECTIVES_IMPLEMENTATION=gloo (see
tests/test_multihost.py).
"""

from __future__ import annotations

import numpy as np


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Multi-process entry: bring up jax.distributed before any device use.
    With no arguments, reads JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID from the environment EXPLICITLY (this jax version's
    auto-detect only covers cluster plugins such as SLURM, not these
    variables). One process per card: the processes that share a machine
    split its GPUs (share_local_devices) unless JAX_LOCAL_DEVICE_IDS,
    which jax reads itself, says otherwise. No-op when already up."""
    import os

    import jax

    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])

    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    except RuntimeError as e:
        if "already initialized" in str(e).lower():
            return
        import sys

        sys.stderr.write(
            "[racon::] warning: --distributed requested but "
            f"jax.distributed.initialize failed ({e}); continuing "
            "single-process\n")
        return
    if not os.environ.get("JAX_LOCAL_DEVICE_IDS"):
        share_local_devices()


def machine_key() -> str:
    """Names this machine: host name plus kernel boot id, so two machines
    that share a host name still differ and every process of one
    container agrees."""
    import socket

    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            boot = f.read().strip()
    except OSError:
        boot = ""
    return f"{socket.gethostname()}/{boot}"


def local_device_ids(keys: list[str], process_id: int) -> list[int] | None:
    """Devices this process may use, given every process's machine_key:
    [its rank among the processes on its machine] when several share the
    machine (one card each, in process-id order), else None (every local
    device)."""
    mine = [p for p, k in enumerate(keys) if k == keys[process_id]]
    return [mine.index(process_id)] if len(mine) > 1 else None


def share_local_devices() -> None:
    """Learns from the coordinator which processes run on this machine
    (each posts its machine_key) and narrows this process's CUDA devices
    to its local_device_ids. Runs between jax.distributed.initialize and
    the first device use, when the device list is still open."""
    import jax
    from jax._src import distributed

    st = distributed.global_state
    me, n = st.process_id, st.num_processes
    st.client.key_value_set_bytes(f"raconx/machine/{me}",
                                  machine_key().encode())
    keys = [st.client.blocking_key_value_get_bytes(f"raconx/machine/{p}",
                                                   600_000).decode()
            for p in range(n)]
    ids = local_device_ids(keys, me)
    if ids is not None:
        jax.config.update("jax_cuda_visible_devices",
                          ",".join(map(str, ids)))


def process_count() -> int:
    import jax

    try:
        return jax.process_count()
    except Exception:
        return 1


def process_index() -> int:
    import jax

    try:
        return jax.process_index()
    except Exception:
        return 0


def is_active() -> bool:
    return process_count() > 1


def shard_range(n: int, index: int | None = None,
                count: int | None = None) -> tuple[int, int]:
    """Contiguous [lo, hi) shard of n items for this process (balanced to
    within one item)."""
    p = process_count() if count is None else count
    i = process_index() if index is None else index
    base, rem = divmod(n, p)
    lo = i * base + min(i, rem)
    return lo, lo + base + (1 if i < rem else 0)


def allgather_blob(local: np.ndarray) -> list[np.ndarray]:
    """All-gather one variable-length 1-D (or 2-D with fixed trailing dims)
    array per process; returns the per-process arrays in process order.
    Shapes are equalized by padding to the global max row count (the only
    way to ride jax's collective path, which needs identical shapes)."""
    from jax.experimental import multihost_utils

    local = np.ascontiguousarray(local)
    rows = np.array([local.shape[0]], np.int64)
    counts = multihost_utils.process_allgather(rows).reshape(-1)
    mx = int(counts.max())
    padded = np.zeros((mx,) + local.shape[1:], local.dtype)
    padded[: local.shape[0]] = local
    gathered = multihost_utils.process_allgather(padded)
    return [gathered[p, : int(counts[p])] for p in range(len(counts))]


def allgather_ragged(items: list[np.ndarray], dtype,
                     trailing: tuple[int, ...] = ()) -> list[np.ndarray]:
    """All-gather a list of variable-length arrays (this process's shard of
    a global item list). Returns the concatenated global list, ordered by
    process then local index. Each item keeps its own length via a
    per-process counts vector."""
    if items:
        blob = np.concatenate([np.asarray(a, dtype).reshape((-1,) + trailing)
                               for a in items])
    else:
        blob = np.zeros((0,) + trailing, dtype)
    lens = np.array([len(a) for a in items], np.int64)
    blobs = allgather_blob(blob)
    lenss = allgather_blob(lens)
    out: list[np.ndarray] = []
    for b, ls in zip(blobs, lenss):
        off = 0
        for n in ls:
            out.append(b[off : off + int(n)])
            off += int(n)
    return out


_g2z_counter = [0]


def _kv_client():
    try:
        from jax._src import distributed

        return distributed.global_state.client
    except Exception:
        return None


def _kv_part_bytes() -> int:
    """Per-message size for KV shard transfers. gRPC / coordination-service
    message limits are version-dependent (4 MB is the classic gRPC default),
    so parts stay small; RACONX_KV_PART_BYTES overrides (tests use it to
    force the multi-part path on tiny payloads)."""
    import os

    return max(64, int(os.environ.get("RACONX_KV_PART_BYTES",
                                      2 << 20)))


def gather_ragged_to0(items: list[np.ndarray], dtype,
                      trailing: tuple[int, ...] = ()) -> list[np.ndarray]:
    """Gather a list of variable-length arrays to process 0 ONLY.

    allgather_ragged broadcasts every shard to every process (~N x the
    bytes process 0 actually needs); consensus output
    is only ever stitched on process 0, so the shards here ride the
    jax.distributed key-value service point-to-point instead: process p
    posts its packed shard once, process 0 fetches each. Returns the
    global item list on process 0 and [] elsewhere. Falls back to
    allgather_ragged when the KV client is unavailable (single process /
    no coordinator service), and — collectively, via a decision key posted
    by process 0 — when any sender's key_value_set raises (e.g. a
    message-size limit): failed senders post a "-1" part count, process 0
    sees it and directs EVERY process into the allgather path so the
    collective stays aligned."""
    import os

    client = _kv_client()
    if client is None or not is_active():
        return allgather_ragged(items, dtype, trailing)
    it = np.dtype(dtype)
    lens = np.array([len(a) for a in items], np.int64)
    if items:
        blob = np.concatenate([np.asarray(a, dtype).reshape((-1,) + trailing)
                               for a in items])
    else:
        blob = np.zeros((0,) + trailing, dtype)
    payload = (np.int64(len(lens)).tobytes() + lens.tobytes()
               + np.ascontiguousarray(blob).tobytes())
    _g2z_counter[0] += 1
    key = f"raconx/g2z/{_g2z_counter[0]}"
    me = process_index()
    PART = _kv_part_bytes()
    TMO = 600_000
    if me != 0:
        try:
            if os.environ.get("RACONX_KV_FORCE_FAIL") == "1":
                raise RuntimeError("forced KV failure (test hook)")
            parts = [payload[o : o + PART] for o in range(0, len(payload),
                                                          PART)] or [b""]
            for i, part in enumerate(parts):
                client.key_value_set_bytes(f"{key}/{me}/{i}", part)
            client.key_value_set_bytes(f"{key}/{me}/n",
                                       str(len(parts)).encode())
        except Exception:
            try:
                client.key_value_set_bytes(f"{key}/{me}/n", b"-1")
            except Exception:
                pass  # KV service down entirely; process 0 will time out
        decision = client.blocking_key_value_get_bytes(f"{key}/decision",
                                                       TMO)
        if decision == b"ag":
            allgather_ragged(items, dtype, trailing)
        return []
    # process 0: read every sender's part count BEFORE deciding the path
    counts = {}
    fell_back = False
    for p in range(1, process_count()):
        try:
            counts[p] = int(client.blocking_key_value_get_bytes(
                f"{key}/{p}/n", TMO))
        except Exception:
            counts[p] = -1
        if counts[p] < 0:
            fell_back = True
    client.key_value_set_bytes(f"{key}/decision",
                               b"ag" if fell_back else b"kv")
    if fell_back:
        return allgather_ragged(items, dtype, trailing)
    out: list[np.ndarray] = []
    for p in range(process_count()):
        if p == 0:
            raw = payload
        else:
            chunks = []
            for i in range(counts[p]):
                chunks.append(client.blocking_key_value_get_bytes(
                    f"{key}/{p}/{i}", TMO))
                client.key_value_delete(f"{key}/{p}/{i}")
            client.key_value_delete(f"{key}/{p}/n")
            raw = b"".join(chunks)
        k = int(np.frombuffer(raw[:8], np.int64)[0])
        ls = np.frombuffer(raw[8 : 8 + 8 * k], np.int64)
        flat = np.frombuffer(raw[8 + 8 * k :], it).reshape((-1,) + trailing)
        off = 0
        for n in ls:
            out.append(flat[off : off + int(n)])
            off += int(n)
    return out


def gather_blob_to0(local: np.ndarray) -> list[np.ndarray]:
    """gather_ragged_to0 for a single array per process: returns the
    per-process arrays in process order on process 0, [] elsewhere."""
    parts = gather_ragged_to0([np.ascontiguousarray(local)],
                              np.asarray(local).dtype,
                              tuple(np.asarray(local).shape[1:]))
    return parts
