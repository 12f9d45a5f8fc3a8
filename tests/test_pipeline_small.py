"""End-to-end pipeline smoke tests on tiny synthetic data (python backend)."""

import gzip

import numpy as np
import pytest

from raconx.errors import RaconError
from raconx.models.polish_model import PolisherConfig, PolisherType
from raconx.polisher import create_polisher


def _write_synthetic(tmp_path, n_reads=12, seed=7):
    rng = np.random.default_rng(seed)
    true = rng.choice(list(b"ACGT"), 800).astype(np.uint8)
    # draft = true with a few errors
    draft = true.copy()
    for pos in rng.choice(800, 10, replace=False):
        draft[pos] = rng.choice(list(b"ACGT"))
    reads = []
    paf_lines = []
    for r in range(n_reads):
        start = int(rng.integers(0, 200))
        end = int(rng.integers(600, 800))
        read = true[start:end].copy()
        # 2% substitution errors
        for pos in rng.choice(len(read), max(1, len(read) // 50), replace=False):
            read[pos] = rng.choice(list(b"ACGT"))
        reads.append((f"read{r}".encode(), read.tobytes()))
        paf_lines.append(
            b"\t".join([f"read{r}".encode(), b"%d" % len(read), b"0",
                        b"%d" % len(read), b"+", b"contig1", b"800",
                        b"%d" % start, b"%d" % end, b"100", b"100", b"60"]))
    (tmp_path / "reads.fasta").write_bytes(
        b"".join(b">" + n + b"\n" + d + b"\n" for n, d in reads))
    (tmp_path / "ovl.paf").write_bytes(b"\n".join(paf_lines) + b"\n")
    (tmp_path / "draft.fasta").write_bytes(
        b">contig1\n" + draft.tobytes() + b"\n")
    return true, draft


def test_polish_improves_draft(tmp_path):
    from raconx.ops.nw_host import edit_distance
    true, draft = _write_synthetic(tmp_path)
    cfg = PolisherConfig(backend="python", window_length=200,
                         quality_threshold=10.0)
    p = create_polisher(str(tmp_path / "reads.fasta"),
                        str(tmp_path / "ovl.paf"),
                        str(tmp_path / "draft.fasta"), cfg)
    p.initialize()
    out = p.polish(drop_unpolished_sequences=True)
    assert len(out) == 1
    name, data = out[0]
    assert name.startswith(b"contig1 LN:i:")
    assert b"RC:i:12" in name
    d_before = edit_distance(draft.tobytes(), true.tobytes())
    d_after = edit_distance(data, true.tobytes())
    assert d_after < d_before
    assert d_after <= 3  # nearly perfect on this easy case


def test_gz_inputs_and_include_unpolished(tmp_path):
    _write_synthetic(tmp_path)
    # gzip every input; add an extra target with no overlaps
    for f in ("reads.fasta", "ovl.paf", "draft.fasta"):
        raw = (tmp_path / f).read_bytes()
        (tmp_path / (f + ".gz")).write_bytes(gzip.compress(raw))
    with open(tmp_path / "draft2.fasta", "wb") as fh:
        fh.write((tmp_path / "draft.fasta").read_bytes())
        fh.write(b">orphan\n" + b"ACGT" * 50 + b"\n")
    cfg = PolisherConfig(backend="python", window_length=200)
    p = create_polisher(str(tmp_path / "reads.fasta.gz"),
                        str(tmp_path / "ovl.paf.gz"),
                        str(tmp_path / "draft2.fasta"), cfg)
    p.initialize()
    out = p.polish(drop_unpolished_sequences=False)
    assert len(out) == 2
    assert out[1][0].startswith(b"orphan")
    assert out[1][1] == b"ACGT" * 50  # unpolished passthrough

    p2 = create_polisher(str(tmp_path / "reads.fasta.gz"),
                         str(tmp_path / "ovl.paf.gz"),
                         str(tmp_path / "draft2.fasta"), cfg)
    p2.initialize()
    out2 = p2.polish(drop_unpolished_sequences=True)
    assert len(out2) == 1


def test_error_empty_overlaps(tmp_path):
    _write_synthetic(tmp_path)
    (tmp_path / "none.paf").write_bytes(b"")
    cfg = PolisherConfig(backend="python", window_length=200)
    p = create_polisher(str(tmp_path / "reads.fasta"),
                        str(tmp_path / "none.paf"),
                        str(tmp_path / "draft.fasta"), cfg)
    with pytest.raises(RaconError, match="empty overlap set"):
        p.initialize()


def test_error_invalid_window():
    with pytest.raises(RaconError, match="invalid window length"):
        create_polisher("a.fasta", "b.paf", "c.fasta",
                        PolisherConfig(window_length=0))


def test_fragment_correction_mode(tmp_path):
    """kF: reads polished against themselves via dual overlaps."""
    rng = np.random.default_rng(3)
    true = rng.choice(list(b"ACGT"), 600).astype(np.uint8)
    reads = []
    for r in range(6):
        read = true.copy()
        for pos in rng.choice(600, 6, replace=False):
            read[pos] = rng.choice(list(b"ACGT"))
        reads.append((f"r{r}".encode(), read.tobytes()))
    (tmp_path / "reads.fasta").write_bytes(
        b"".join(b">" + n + b"\n" + d + b"\n" for n, d in reads))
    lines = []
    for a in range(6):
        for b in range(6):
            if a == b:
                continue
            lines.append(b"\t".join(
                [b"r%d" % a, b"600", b"0", b"600", b"+", b"r%d" % b, b"600",
                 b"0", b"600", b"550", b"600", b"60"]))
    (tmp_path / "ava.paf").write_bytes(b"\n".join(lines) + b"\n")
    cfg = PolisherConfig(backend="python", type=PolisherType.kF,
                         window_length=300)
    p = create_polisher(str(tmp_path / "reads.fasta"),
                        str(tmp_path / "ava.paf"),
                        str(tmp_path / "reads.fasta"), cfg)
    p.initialize()
    out = p.polish(drop_unpolished_sequences=True)
    assert len(out) == 6
    # corrected reads should be closer to truth than originals
    from raconx.ops.nw_host import edit_distance
    for (name, data), (_, orig) in zip(out, reads):
        assert name.startswith(b"r")
        assert b"r LN:i:" in name  # kF adds the "r" tag
        assert edit_distance(data, true.tobytes()) <= \
            edit_distance(orig, true.tobytes())


def test_ngs_mode_short_reads_no_trimming(tmp_path):
    """Illumina-like input: average read length <= 1000 selects the kNGS
    window type (reference: src/polisher.cpp:276-277) and consensus ends
    are NOT coverage-trimmed (trimming is a kTGS-only rule,
    src/window.cpp:118-139)."""
    from raconx.core.windows import WINDOW_TYPE_NGS

    rng = np.random.default_rng(3)
    true = rng.choice(list(b"ACGT"), 700).astype(np.uint8)
    draft = true.copy()
    for pos in rng.choice(700, 8, replace=False):
        draft[pos] = rng.choice(list(b"ACGT"))
    reads, paf = [], []
    # short (<=300bp) reads covering only the middle: with TGS trimming the
    # low-coverage window ends would be cut; NGS must keep full length
    for r in range(10):
        s = 150 + int(rng.integers(0, 100))
        e = min(s + 300, 640)
        read = true[s:e].copy()
        for pos in rng.choice(len(read), 3, replace=False):
            read[pos] = rng.choice(list(b"ACGT"))
        reads.append((f"sr{r}".encode(), read.tobytes()))
        paf.append(b"\t".join([f"sr{r}".encode(), b"%d" % len(read), b"0",
                               b"%d" % len(read), b"+", b"ctg", b"700",
                               b"%d" % s, b"%d" % e, b"50", b"50", b"60"]))
    (tmp_path / "r.fasta").write_bytes(
        b"".join(b">" + n + b"\n" + d + b"\n" for n, d in reads))
    (tmp_path / "o.paf").write_bytes(b"\n".join(paf) + b"\n")
    (tmp_path / "d.fasta").write_bytes(b">ctg\n" + draft.tobytes() + b"\n")

    cfg = PolisherConfig(backend="python", num_threads=1, window_length=700)
    p = create_polisher(str(tmp_path / "r.fasta"), str(tmp_path / "o.paf"),
                        str(tmp_path / "d.fasta"), cfg)
    p.initialize()
    assert p.windows.window_type == WINDOW_TYPE_NGS
    out = p.polish(drop_unpolished_sequences=False)
    assert len(out) == 1
    # untrimmed: the uncovered window ends survive in the output
    assert len(out[0][1]) >= 650
