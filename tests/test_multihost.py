"""Multi-process smoke test: 2 jax.distributed CPU processes polish the same
input; sharded align + consensus with cross-process gathers must produce
output byte-identical to a single-process run (SURVEY.md §5.8 mapping of
the reference's multi-GPU dispatch, src/cuda/cudapolisher.cpp:165-180).

Each process runs with gloo CPU collectives (the CPU stand-in for NCCL)
and its own local devices; process 0 writes the FASTA. The device-stage
runs use the stages' jnp sweeps (kernels=False), the only ones a CPU has."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from raconx.native import loader

if not loader.available():
    pytest.skip("native runtime unavailable", allow_module_level=True)

WORKER = r"""
import sys
import jax

pid = int(sys.argv[1])
port = sys.argv[2]
out_path = sys.argv[3]
data_dir = sys.argv[4]
backend = sys.argv[5] if len(sys.argv) > 5 else "native"

jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=2, process_id=pid)

from raconx.models.polish_model import PolisherConfig, PolisherType
from raconx.polisher import create_polisher

if backend == "device":
    # the dist x mesh composition: this process must shard its device
    # dispatches over its own LOCAL multi-device mesh while window shards
    # ride parallel/dist.py
    from raconx import backends
    from raconx.ops.device_align import DeviceAlignStage
    from raconx.ops.device_consensus import DeviceConsensusStage
    from raconx.parallel.mesh import active_mesh

    mesh = active_mesh()
    assert mesh is not None and mesh.devices.size == len(
        jax.local_devices()) and mesh.devices.size > 1, mesh
    backends.get_align_stage = lambda c: DeviceAlignStage(c, kernels=False)
    backends.get_consensus_stage = (
        lambda c: DeviceConsensusStage(c, kernels=False))
    backend = "native"

cfg = PolisherConfig(backend=backend, num_threads=1, match=5, mismatch=-4,
                     gap=-8, refine_passes=2)
p = create_polisher(f"{data_dir}/reads.fasta", f"{data_dir}/ovl.paf",
                    f"{data_dir}/draft.fasta", cfg)
p.initialize()
out = p.polish(drop_unpolished_sequences=True)
if pid == 0:
    with open(out_path, "wb") as f:
        for name, data in out:
            f.write(b">" + name + b"\n" + data + b"\n")
else:
    assert out == [], "only process 0 emits records"
"""


DIST_WORKER = r"""
import sys
import jax
import numpy as np
from jax._src import xla_bridge
from raconx.parallel import dist

pid, port = int(sys.argv[1]), sys.argv[2]
dist.initialize(f"localhost:{port}", 2, pid)
ids = dist.allgather_blob(np.array([pid], np.int32))
print(xla_bridge.CUDA_VISIBLE_DEVICES.value, len(jax.local_devices()),
      len(jax.devices()), [int(a[0]) for a in ids])
"""


def _make_dataset(d):
    rng = np.random.default_rng(11)
    ACGT = list(b"ACGT")
    true = rng.choice(ACGT, 4000).astype(np.uint8)
    draft = true.copy()
    for pos in rng.choice(4000, 60, replace=False):
        draft[pos] = rng.choice(ACGT)
    reads, paf = [], []
    for r in range(24):
        s = int(rng.integers(0, 1500))
        e = int(rng.integers(2500, 4000))
        read = true[s:e].copy()
        for pos in rng.choice(len(read), len(read) // 40, replace=False):
            read[pos] = rng.choice(ACGT)
        name = f"read{r}".encode()
        reads.append((name, read.tobytes()))
        paf.append(b"\t".join([
            name, b"%d" % len(read), b"0", b"%d" % len(read), b"+", b"ctg",
            b"4000", b"%d" % s, b"%d" % e, b"9", b"9", b"60"]))
    (d / "reads.fasta").write_bytes(
        b"".join(b">" + n + b"\n" + s + b"\n" for n, s in reads))
    (d / "ovl.paf").write_bytes(b"\n".join(paf) + b"\n")
    (d / "draft.fasta").write_bytes(b">ctg\n" + draft.tobytes() + b"\n")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clean_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_NUM_CPU_DEVICES"] = "1"
    env["JAX_CPU_COLLECTIVES_IMPLEMENTATION"] = "gloo"
    env.pop("XLA_FLAGS", None)
    # the worker script lives in tmp_path, so sys.path[0] won't cover the
    # repo — make the package importable regardless of install state
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run_dist_workers(tmp_path, env):
    worker = tmp_path / "dist_worker.py"
    worker.write_text(DIST_WORKER)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(worker), str(pid),
                               str(port)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, cwd=REPO)
             for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("dist worker timed out")
        assert p.returncode == 0, err.decode()[-2000:]
        outs.append(out.decode().splitlines()[-1].split())  # after banners
    return outs


def test_dist_initialize_gives_each_process_one_card(tmp_path):
    """Two processes on one machine, coordinator on localhost: each is
    narrowed to its own CUDA device (0 and 1), and the collectives work."""
    outs = _run_dist_workers(tmp_path, _clean_env())
    assert [o[0] for o in outs] == ["0", "1"]
    assert all(o[3:] == ["[0,", "1]"] for o in outs)


@pytest.mark.gpu
def test_dist_initialize_one_card_per_process_on_gpus(tmp_path, gpu):
    """On a machine with 2+ GPUs: each of two processes sees one card,
    the job sees two, and an all-gather crosses the cards."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs two GPUs")
    env = _clean_env()
    env["JAX_PLATFORMS"] = "cuda"
    env.pop("JAX_CPU_COLLECTIVES_IMPLEMENTATION")
    env["XLA_PYTHON_CLIENT_MEM_FRACTION"] = "0.05"
    outs = _run_dist_workers(tmp_path, env)
    assert [o[:3] for o in outs] == [["0", "1", "2"], ["1", "1", "2"]]
    assert all(o[3:] == ["[0,", "1]"] for o in outs)


def test_two_process_polish_matches_single(tmp_path):
    _make_dataset(tmp_path)
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    port = _free_port()
    out2 = tmp_path / "out2.fasta"
    env = _clean_env()
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), str(port), str(out2),
             str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            cwd=REPO)
        for pid in range(2)
    ]
    for p in procs:
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-host worker timed out")
        assert p.returncode == 0, err.decode()[-2000:]

    # single-process reference run (same config, same backend)
    from raconx.models.polish_model import PolisherConfig
    from raconx.polisher import create_polisher

    cfg = PolisherConfig(backend="native", num_threads=1, match=5,
                         mismatch=-4, gap=-8, refine_passes=2)
    p1 = create_polisher(str(tmp_path / "reads.fasta"),
                         str(tmp_path / "ovl.paf"),
                         str(tmp_path / "draft.fasta"), cfg)
    p1.initialize()
    single = p1.polish(drop_unpolished_sequences=True)
    expect = b"".join(b">" + n + b"\n" + d + b"\n" for n, d in single)
    assert out2.read_bytes() == expect


def test_dist_times_mesh_polish_matches_single(tmp_path, monkeypatch):
    """2 jax.distributed processes, EACH sharding its device dispatches
    over its own 4-device local mesh, must produce output byte-identical
    to a single-process run of the same device stages."""
    _make_dataset(tmp_path)
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    port = _free_port()
    out2 = tmp_path / "out_dm.fasta"
    env = _clean_env()
    env["JAX_NUM_CPU_DEVICES"] = "4"
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), str(port), str(out2),
             str(tmp_path), "device"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            cwd=REPO)
        for pid in range(2)
    ]
    for p in procs:
        try:
            _, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("dist x mesh worker timed out")
        assert p.returncode == 0, err.decode()[-2000:]

    # single-process reference run, same device stages on the test
    # session's own 8-device mesh — mesh size must not affect bytes
    from raconx import backends
    from raconx.models.polish_model import PolisherConfig
    from raconx.ops.device_align import DeviceAlignStage
    from raconx.ops.device_consensus import DeviceConsensusStage
    from raconx.polisher import create_polisher

    monkeypatch.setattr(backends, "get_align_stage",
                        lambda c: DeviceAlignStage(c, kernels=False))
    monkeypatch.setattr(backends, "get_consensus_stage",
                        lambda c: DeviceConsensusStage(c, kernels=False))
    cfg = PolisherConfig(backend="native", num_threads=1, match=5,
                         mismatch=-4, gap=-8, refine_passes=2)
    p1 = create_polisher(str(tmp_path / "reads.fasta"),
                         str(tmp_path / "ovl.paf"),
                         str(tmp_path / "draft.fasta"), cfg)
    p1.initialize()
    single = p1.polish(drop_unpolished_sequences=True)
    expect = b"".join(b">" + n + b"\n" + d + b"\n" for n, d in single)
    assert out2.read_bytes() == expect


def test_distributed_cli_env_driven(tmp_path):
    """`raconx --distributed` with env-driven initialization must (a)
    read JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID
    itself (this jax's auto-detect covers only cluster plugins) and (b)
    emit CLEAN FASTA on process 0's stdout — collective backends print
    connection banners to fd 1, which the CLI shields away (round-3 bug:
    gloo's "[Gloo] Rank..." line corrupted piped output)."""
    _make_dataset(tmp_path)
    port = _free_port()
    env = _clean_env()
    procs = []
    for pid in range(2):
        e = dict(env)
        e["JAX_COORDINATOR_ADDRESS"] = f"localhost:{port}"
        e["JAX_NUM_PROCESSES"] = "2"
        e["JAX_PROCESS_ID"] = str(pid)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "raconx.cli", "--distributed",
             "--backend", "native", "-t", "1",
             str(tmp_path / "reads.fasta"), str(tmp_path / "ovl.paf"),
             str(tmp_path / "draft.fasta")],
            env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            cwd=REPO))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed CLI worker timed out")
        assert p.returncode == 0, err.decode()[-2000:]
        outs.append(out)
    assert outs[0].startswith(b">ctg"), outs[0][:80]
    assert b"Gloo" not in outs[0]
    assert outs[1] == b""
