"""Backend selection (no fallback that hides the device) and the stages'
batch planning.

--backend gpu without a GPU is an error; auto without a GPU runs the
native host path and says so; with a GPU present, a device stage that
cannot be built is an error, never a silent host run."""

import pytest

from raconx import backends
from raconx.errors import RaconError
from raconx.models.polish_model import PolisherConfig
from raconx.native import loader

if not loader.available():
    pytest.skip("native runtime unavailable", allow_module_level=True)


def test_gpu_backend_without_gpu_is_an_error():
    assert not backends.gpu_present()  # the suite runs on CPU
    with pytest.raises(RaconError, match="no GPU"):
        backends.get_align_stage(PolisherConfig(backend="gpu"))
    with pytest.raises(RaconError, match="no GPU"):
        backends.get_consensus_stage(PolisherConfig(backend="gpu"))


def test_auto_without_gpu_runs_native_and_says_so(capsys, monkeypatch):
    from raconx.native.align_stage import NativeAlignStage
    from raconx.native.consensus_stage import NativeConsensusStage

    monkeypatch.setattr(backends, "_notes", set())
    cfg = PolisherConfig(backend="auto")
    assert isinstance(backends.get_align_stage(cfg), NativeAlignStage)
    assert isinstance(backends.get_consensus_stage(cfg),
                      NativeConsensusStage)
    assert "no GPU found" in capsys.readouterr().err


@pytest.mark.parametrize("name", ["metal", "cuda", ""])
def test_unknown_backend_is_an_error(name):
    with pytest.raises(RaconError, match="unknown backend"):
        backends.use_device(PolisherConfig(backend=name))


def test_gpu_present_builds_kernel_stages(monkeypatch):
    from raconx.ops.device_align import DeviceAlignStage
    from raconx.ops.device_consensus import DeviceConsensusStage

    monkeypatch.setattr(backends, "gpu_present", lambda: True)
    for be in ("auto", "gpu"):
        cfg = PolisherConfig(backend=be)
        a = backends.get_align_stage(cfg)
        c = backends.get_consensus_stage(cfg)
        assert isinstance(a, DeviceAlignStage) and a.kernels
        assert isinstance(c, DeviceConsensusStage) and c.kernels


def test_gpu_present_without_native_runtime_raises(monkeypatch):
    monkeypatch.setattr(backends, "gpu_present", lambda: True)
    monkeypatch.setattr(loader, "available", lambda: False)
    for be in ("auto", "gpu"):
        with pytest.raises(RaconError, match="native runtime"):
            backends.get_consensus_stage(PolisherConfig(backend=be))


def test_out_of_range_scores(monkeypatch, capsys):
    from raconx.native.consensus_stage import NativeConsensusStage

    monkeypatch.setattr(backends, "gpu_present", lambda: True)
    monkeypatch.setattr(backends, "_notes", set())
    with pytest.raises(RaconError, match="scores"):
        backends.get_consensus_stage(PolisherConfig(backend="gpu",
                                                    gap=-200))
    st = backends.get_consensus_stage(PolisherConfig(backend="auto",
                                                     gap=-200))
    assert isinstance(st, NativeConsensusStage)
    assert "native host path" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["--backend", "gpu"], ["-c", "4"],
                                  ["--cudaaligner-batches", "1"]])
def test_cli_gpu_request_without_gpu_exits_1(argv, tmp_path, capsys):
    from raconx.cli import main

    for f in ("r.fasta", "d.fasta"):
        (tmp_path / f).write_bytes(b">a\nACGT\n")
    (tmp_path / "o.paf").write_bytes(b"")
    rc = main(argv + [str(tmp_path / "r.fasta"), str(tmp_path / "o.paf"),
                      str(tmp_path / "d.fasta")])
    assert rc == 1
    assert "no GPU" in capsys.readouterr().err


def test_compile_cache_default_is_ignored_path_in_checkout():
    """Without JAX_COMPILATION_CACHE_DIR the cache sits at one fixed path
    inside the checkout (the path is part of the cache key), which git
    ignores."""
    import os

    from raconx.utils import jaxenv

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert jaxenv.CACHE_DIR == os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_setup_jax_leaves_env_cache_alone(monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, setup_jax configures nothing
    (JAX reads the variable itself); without it, the fixed directory."""
    import jax
    from raconx.utils import jaxenv

    seen = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.append((k, v)))
    monkeypatch.setattr(jaxenv, "_done", False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    jaxenv.setup_jax()
    assert seen == []
    monkeypatch.setattr(jaxenv, "_done", False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    jaxenv.setup_jax()
    assert seen == [("jax_compilation_cache_dir", jaxenv.CACHE_DIR)]


@pytest.mark.parametrize("keys,pid,want", [
    (["a/1", "a/1", "a/1", "a/1"], 2, [2]),  # one machine, 4 processes
    (["a/1", "b/1", "a/1", "b/1"], 2, [1]),  # 2 machines x 2 processes
    (["a/1", "b/1", "a/1", "b/1"], 1, [0]),
    (["a/1", "a/2"], 1, None),  # same host name, other machine
    (["a/1", "b/1", "c/1"], 0, None),  # one process per machine
    (["a/1"], 0, None)])
def test_distributed_one_card_per_process(keys, pid, want):
    from raconx.parallel import dist

    assert dist.local_device_ids(keys, pid) == want


def test_chunk_plan_canonical_ladder():
    """chunk_plan equalizes chunk sizes (no tiny remainder dispatch) and
    quantizes accelerator padded batches to the canonical ladder, so each
    tier compiles at most len(_BP_LADDER) programs."""
    from raconx.ops.device_consensus import _BP_LADDER, chunk_plan

    # covers [0, k) exactly, in order, for many k/step combos
    for k in (1, 5, 1023, 1024, 1025, 4097, 8192, 8193, 47321, 100000):
        for step in (1024, 6553, 8192):
            plan = chunk_plan(k, step, True)
            assert plan[0][0] == 0 and plan[-1][1] == k
            assert all(a[1] == b[0] for a, b in zip(plan, plan[1:]))
            sizes = [hi - lo for lo, hi, _ in plan]
            # equalized: no tiny remainder chunk (deviation < n_chunks)
            assert max(sizes) - min(sizes) < max(2, len(plan))
            for lo, hi, bp in plan:
                assert bp is not None and bp >= hi - lo
                assert bp in _BP_LADDER or bp == step

    # k > step: every chunk lands on the SAME ladder size (step's pow2)
    plan = chunk_plan(47321, 8192, True)
    assert {bp for _, _, bp in plan} == {8192}
    # small rounds quantize up, never below the ladder floor
    assert chunk_plan(37, 8192, True) == [(0, 37, 1024)]
    assert chunk_plan(3000, 8192, True) == [(0, 3000, 4096)]
    # CPU runs: exact sizes, bp deferred (None)
    assert chunk_plan(3000, 8192, False) == [(0, 3000, None)]
    assert chunk_plan(0, 8192, True) == []


@pytest.mark.parametrize("cap,band", [(1280, 512), (2560, 384), (2560, 768),
                                      (5120, 512), (5120, 1024),
                                      (10240, 768), (10240, 2048)])
def test_chunk_plan_never_pads_past_step(cap, band):
    """Wide tiers' steps (6553, 4369, 2184, ...) fall between ladder rungs:
    a chunk is padded to step at most, never to a larger rung."""
    from raconx.ops.device_consensus import _chunk_size, chunk_plan

    step = _chunk_size(cap, band)
    assert step < 8192
    for k in (1, 1025, step - 1, step, step + 1, 5 * step + 3):
        for lo, hi, bp in chunk_plan(k, step, True):
            assert hi - lo <= bp <= step
