"""Device consensus stage vs the native backend. On CPU the stage runs
XLA's compile of the jnp sweep (kernels=False); the CUDA kernel path is
covered on the card by chip_smoke.py and the `gpu`-marked tests."""

import numpy as np
import pytest

from raconx.models.polish_model import PolisherConfig
from raconx.native import loader

if not loader.available():
    pytest.skip("native runtime unavailable", allow_module_level=True)

from raconx.ops.device_consensus import DeviceConsensusStage
from raconx.native.consensus_stage import NativeConsensusStage
from raconx.polisher import create_polisher
from raconx.utils.logger import Logger


def _build_windows(tmp_path, seed=5, n_reads=14, glen=900, wlen=150):
    rng = np.random.default_rng(seed)
    ACGT = np.frombuffer(b"ACGT", np.uint8)
    true = rng.choice(ACGT, glen)
    draft = true.copy()
    for pos in rng.choice(glen, 12, replace=False):
        draft[pos] = rng.choice(ACGT)
    # delete a few bases from the draft so insertions must be recovered
    draft = np.delete(draft, rng.choice(glen, 5, replace=False))
    reads, paf = [], []
    for r in range(n_reads):
        s = int(rng.integers(0, 120))
        e = int(rng.integers(glen - 120, glen))
        read = true[s:e].copy()
        for pos in rng.choice(len(read), len(read) // 40, replace=False):
            read[pos] = rng.choice(ACGT)
        reads.append((b"r%d" % r, read.tobytes()))
        paf.append(b"\t".join([
            b"r%d" % r, b"%d" % len(read), b"0", b"%d" % len(read), b"+",
            b"ctg", b"%d" % len(draft), b"%d" % s,
            b"%d" % min(len(draft), e), b"9", b"9", b"60"]))
    (tmp_path / "reads.fasta").write_bytes(
        b"".join(b">" + n + b"\n" + d + b"\n" for n, d in reads))
    (tmp_path / "ovl.paf").write_bytes(b"\n".join(paf) + b"\n")
    (tmp_path / "draft.fasta").write_bytes(b">ctg\n" + draft.tobytes() + b"\n")
    cfg = PolisherConfig(backend="native", num_threads=2, window_length=wlen,
                         match=5, mismatch=-4, gap=-8)
    p = create_polisher(str(tmp_path / "reads.fasta"),
                        str(tmp_path / "ovl.paf"),
                        str(tmp_path / "draft.fasta"), cfg)
    p.initialize()
    return p, cfg, true


def test_device_stage_matches_native(tmp_path):
    p, cfg, true = _build_windows(tmp_path)
    native = NativeConsensusStage(cfg)
    want_cons, want_pol = native.consensus_windows(p.windows, cfg, Logger())

    dev = DeviceConsensusStage(cfg, kernels=False)
    got_cons, got_pol = dev.consensus_windows(p.windows, cfg, Logger())

    assert got_pol == want_pol
    # same integer DP, same DIAG > UP > LEFT tie-breaking: equal bytes
    assert got_cons == want_cons

    # and quality: stitched consensus close to the truth
    from raconx.native import bindings
    full = b"".join(got_cons)
    d = bindings.edit_distance(full, true.tobytes())
    assert d <= 8


def test_device_stage_polish_quality(tmp_path):
    """Full pipeline with the device stage: corrects the draft, and its
    counters say every item ran on the device or the host fallback."""
    from raconx.native import bindings
    p, cfg, true = _build_windows(tmp_path, seed=9)
    cfg_dev = PolisherConfig(**{**cfg.__dict__, "trim": False})
    dev = DeviceConsensusStage(cfg_dev, kernels=False)
    cons, pol = dev.consensus_windows(p.windows, cfg_dev, Logger())
    assert dev.stats["device_items"] > 0
    assert sum(dev.stats["tiers"].values()) + dev.stats["host_items"] >= (
        dev.stats["device_items"])
    full = b"".join(cons)
    d = bindings.edit_distance(full, true.tobytes())
    assert d <= 8


def test_kernel_choice_never_falls_back(tmp_path):
    """kernels=True means the CUDA sweep: where it cannot run (no nvcc, no
    card) the dispatch raises instead of quietly running something else."""
    p, cfg, _ = _build_windows(tmp_path, seed=11, n_reads=6)
    dev = DeviceConsensusStage(cfg, kernels=True)
    with pytest.raises(Exception):
        dev.consensus_windows(p.windows, cfg, Logger())


def test_accelerator_depth_cap_and_band_knobs():
    """--max-window-depth caps layers per window on the accelerator path
    (reference GPU MAX_DEPTH_PER_WINDOW, src/cuda/cudapolisher.cpp:226);
    --band-width sets a minimum device band for overlap alignment."""
    import numpy as np
    from raconx.core.store import SequenceStore
    from raconx.core.windows import WindowSet, WINDOW_TYPE_TGS
    from raconx.ops.device_consensus import _StaticItems
    import raconx.ops.device_align as astm
    from raconx.models.polish_model import PolisherConfig

    # tiny store: one 100bp target + 8 reads of 100bp
    parts = [np.full(100, 65, np.uint8)] * 9
    off = np.arange(10, dtype=np.int64) * 100
    store = SequenceStore([b"t"] + [b"r%d" % i for i in range(8)],
                          np.concatenate(parts), off,
                          np.zeros(0, np.uint8), np.zeros(10, np.int64))
    ws = WindowSet(store, 1, 100, WINDOW_TYPE_TGS)
    bp = np.array([[0, 0, 99, 99]], np.int64)  # (t_first, q_first, t_last, q_last)
    for r in range(8):
        ws.assign_overlap(bp, r + 1, 0, False, 10.0)
    ws.freeze()
    st_all = _StaticItems(ws, [0])
    st_cap = _StaticItems(ws, [0], depth_cap=3)
    assert st_all.n_items == 8 and st_cap.n_items == 3

    # band knob: only tiers with band >= requested survive
    cfg = PolisherConfig(band_width=2048)
    stage = astm.DeviceAlignStage(cfg, kernels=False)
    assert stage.kernels is False
    tiers = astm._TIERS
    filtered = tuple(t for t in tiers if t[1] >= cfg.band_width)
    assert filtered and all(b >= 2048 for _, b in filtered)


def test_prefetch_pool_and_disable(monkeypatch):
    """ops/prefetch basics: RACONX_FETCH_THREADS=0 disables the pool
    (callers then fetch inline), a positive count returns a future whose
    resolve() yields the host array; resolve(payload, None) is the
    inline path."""
    import numpy as np

    from raconx.ops import prefetch

    monkeypatch.setenv("RACONX_FETCH_THREADS", "0")
    assert prefetch.submit(np.arange(4)) is None
    arr = np.arange(4)
    assert np.array_equal(prefetch.resolve(arr, None), arr)

    monkeypatch.setenv("RACONX_FETCH_THREADS", "2")
    fut = prefetch.submit(np.arange(3))
    assert fut is not None
    assert np.array_equal(prefetch.resolve(None, fut), np.arange(3))

    # malformed env falls back to the default worker count
    monkeypatch.setenv("RACONX_FETCH_THREADS", "bogus")
    fut = prefetch.submit(np.arange(2))
    assert fut is not None and np.array_equal(fut.result(), np.arange(2))
