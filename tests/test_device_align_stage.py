"""Device overlap-alignment stage vs the native backend (on CPU the stage
runs XLA's compile of the jnp Myers sweep, kernels=False)."""

import numpy as np
import pytest

from raconx.models.polish_model import PolisherConfig
from raconx.native import loader

if not loader.available():
    pytest.skip("native runtime unavailable", allow_module_level=True)

from raconx.ops.device_align import DeviceAlignStage
from raconx.polisher import create_polisher


def _build(tmp_path, seed=21):
    rng = np.random.default_rng(seed)
    ACGT = np.frombuffer(b"ACGT", np.uint8)
    glen = 700
    true = rng.choice(ACGT, glen)
    draft = true.copy()
    for pos in rng.choice(glen, 8, replace=False):
        draft[pos] = rng.choice(ACGT)
    reads, paf = [], []
    for r in range(10):
        s = int(rng.integers(0, 80))
        e = int(rng.integers(glen - 80, glen))
        read = true[s:e].copy()
        for pos in rng.choice(len(read), len(read) // 30, replace=False):
            read[pos] = rng.choice(ACGT)
        if r % 2:  # reverse-strand overlaps exercise revcomp coordinates
            rc = read[::-1].copy()
            comp = np.frombuffer(bytes(rc).translate(
                bytes.maketrans(b"ACGT", b"TGCA")), np.uint8)
            reads.append((b"r%d" % r, comp.tobytes()))
            strand = b"-"
        else:
            reads.append((b"r%d" % r, read.tobytes()))
            strand = b"+"
        paf.append(b"\t".join([
            b"r%d" % r, b"%d" % len(read), b"0", b"%d" % len(read), strand,
            b"ctg", b"%d" % glen, b"%d" % s, b"%d" % e, b"9", b"9", b"60"]))
    (tmp_path / "reads.fasta").write_bytes(
        b"".join(b">" + n + b"\n" + d + b"\n" for n, d in reads))
    (tmp_path / "ovl.paf").write_bytes(b"\n".join(paf) + b"\n")
    (tmp_path / "draft.fasta").write_bytes(b">ctg\n" + draft.tobytes() + b"\n")
    cfg = PolisherConfig(backend="native", num_threads=2, window_length=100)
    p = create_polisher(str(tmp_path / "reads.fasta"),
                        str(tmp_path / "ovl.paf"),
                        str(tmp_path / "draft.fasta"), cfg)
    # run ingest only up to overlaps (initialize would consume breaking points)
    return p, cfg


def test_device_align_stage_matches_native(tmp_path, monkeypatch):
    p, cfg = _build(tmp_path)
    p.initialize()
    # a fresh polisher driven through the device stage (initialize is
    # one-shot)
    import raconx.backends as backends

    stage = DeviceAlignStage(cfg, kernels=False)
    monkeypatch.setattr(backends, "get_align_stage", lambda c: stage)
    p2, _ = _build(tmp_path)
    p2.initialize()
    assert stage.stats["device_items"] == 10
    assert sum(stage.stats["tiers"].values()) == 10

    # identical layer assignment implies identical breaking points downstream
    w1, w2 = p.windows, p2.windows
    assert np.array_equal(w1.lay_win, w2.lay_win)
    assert np.array_equal(w1.lay_begin, w2.lay_begin)
    assert np.array_equal(w1.lay_end, w2.lay_end)
    assert np.array_equal(w1.lay_qbegin, w2.lay_qbegin)
    assert np.array_equal(w1.lay_qlen, w2.lay_qlen)
