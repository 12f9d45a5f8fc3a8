"""chip_smoke.py's phases at a tiny size on CPU, and its refusal to run
anywhere but on a GPU. The phases' device runs use the stages' jnp sweeps
here (the CUDA kernels need the card)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from raconx.native import loader

if not loader.available():
    pytest.skip("native runtime unavailable", allow_module_level=True)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def xla_device_stages(monkeypatch):
    """Let --backend gpu build the device stages on CPU, with the jnp
    sweeps in place of the CUDA kernels."""
    from raconx import backends
    from raconx.ops.device_align import DeviceAlignStage
    from raconx.ops.device_consensus import DeviceConsensusStage

    monkeypatch.setattr(backends, "gpu_present", lambda: True)
    for cls in (DeviceAlignStage, DeviceConsensusStage):
        init = cls.__init__
        monkeypatch.setattr(cls, "__init__",
                            lambda self, cfg, kernels, _i=init: _i(self, cfg,
                                                                   False))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("smoke"))
    true = chip_smoke.make_data(wd, genome_bp=12_000, coverage=6,
                                read_len=2000, err=0.05)
    return wd, true


def test_device_phase_refuses_cpu():
    with pytest.raises(SystemExit, match="not 'gpu'"):
        chip_smoke.device_phase("gpu")
    assert chip_smoke.device_phase("cpu")[0].platform == "cpu"


def test_kernel_phase_compares_at_tiny_size(capsys):
    chip_smoke.kernel_phase([(128, 64)], [(256, 128)], batch=6,
                            kernel=False)
    out = capsys.readouterr().out
    assert "nw 128/64 x6: moves+scores equal, walk payloads equal" in out
    assert "myers 256/128 x6: planes equal, walk payloads equal" in out
    assert "memory_analysis" in out


def test_e2e_phase_gpu_equals_native(dataset, xla_device_stages, capsys):
    wd, true = dataset
    chip_smoke.e2e_phase(wd, true, threads=2)
    out = capsys.readouterr().out
    assert "byte-identical" in out
    counters = json.loads(out.split("stage counters: ")[1].split("\n")[0])
    assert counters["DeviceAlignStage"]["device_items"] > 0
    assert counters["DeviceConsensusStage"]["device_items"] > 0


def test_mesh_phase_matches_one_device(dataset, xla_device_stages, capsys):
    wd, _ = dataset
    chip_smoke.mesh_phase(wd, 4, threads=2)
    assert "4-card mesh and one-card FASTA byte-identical" in (
        capsys.readouterr().out)


@pytest.mark.parametrize("alone", [False, True])
def test_script_fails_without_gpu_or_repo(alone, tmp_path):
    """No JSON result and a non-zero exit on a CPU-only JAX, and in a
    directory that holds chip_smoke.py and nothing else of the repo."""
    cwd = REPO
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
