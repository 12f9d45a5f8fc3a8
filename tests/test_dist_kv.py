"""gather_ragged_to0 transport tests: the KV point-to-point path must
survive (a) payloads larger than one KV message — shipped in bounded parts
(RACONX_KV_PART_BYTES) — and (b) a sender whose key_value_set raises,
which must divert EVERY process into the allgather fallback collectively
(the decision-key protocol) instead of hanging or dropping data."""

import os
import socket
import subprocess
import sys

import pytest

WORKER = r"""
import sys
import numpy as np
import jax

pid = int(sys.argv[1])
port = sys.argv[2]

jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=2, process_id=pid)

from raconx.parallel import dist

# per-process shard: process 0 holds 2 items, process 1 holds 3; total
# bytes (~40 KB at part size 1 KB) force the multi-part path
items = ([np.arange(100, dtype=np.int32), np.arange(7, dtype=np.int32)]
         if pid == 0 else
         [np.full(9000, 5, np.int32), np.arange(3, dtype=np.int32) * 2,
          np.arange(11, dtype=np.int32) + 1])
out = dist.gather_ragged_to0(items, np.int32)
if pid == 0:
    assert len(out) == 5, len(out)
    assert np.array_equal(out[0], np.arange(100, dtype=np.int32))
    assert np.array_equal(out[1], np.arange(7, dtype=np.int32))
    assert np.array_equal(out[2], np.full(9000, 5, np.int32))
    assert np.array_equal(out[3], np.arange(3, dtype=np.int32) * 2)
    assert np.array_equal(out[4], np.arange(11, dtype=np.int32) + 1)
else:
    assert out == [], out

# second call on the same processes: counter/keys must not collide
out2 = dist.gather_ragged_to0([np.array([pid + 41], np.int64)], np.int64)
if pid == 0:
    assert [int(a[0]) for a in out2] == [41, 42]
print("WORKER_OK")
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_pair(tmp_path, extra_env):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_NUM_CPU_DEVICES"] = "1"
    env["JAX_CPU_COLLECTIVES_IMPLEMENTATION"] = "gloo"
    env.pop("XLA_FLAGS", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra_env)
    procs = [
        subprocess.Popen([sys.executable, str(worker), str(pid), str(port)],
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, cwd=repo)
        for pid in range(2)
    ]
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("dist KV worker timed out")
        assert p.returncode == 0, err.decode()[-2000:]
        assert b"WORKER_OK" in out


def test_gather_to0_multi_part(tmp_path):
    _run_pair(tmp_path, {"RACONX_KV_PART_BYTES": "1024"})


def test_gather_to0_kv_failure_falls_back(tmp_path):
    _run_pair(tmp_path, {"RACONX_KV_FORCE_FAIL": "1"})
