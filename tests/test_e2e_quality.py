"""End-to-end consensus quality on the reference's golden dataset.

The reference pins exact edit distances of the (reverse-complemented)
polished contig vs the true reference (test/racon_test.cpp:88-152;
BASELINE.md). Our star-POA with iterative refinement produces different —
measurably better — output, so the contract here is: at least as good as the
reference's own CPU golden, plus a pinned regression band for our result.

Round-1 measured values (scores 5/-4/-8, w=500, q=10, 4 threads):
  FASTQ+PAF 1150  (ref CPU 1312, ref CUDA 1385)
  FASTQ+SAM 1127  (ref CPU 1317, ref CUDA 1541)
  FASTA+PAF 1244  (ref CPU 1566), FASTA+SAM 1622 (ref CPU 1770)
  FASTQ+PAF m1/x-1/g-1 1106 (ref 1321); w=1000 1079 (ref 1289)

The SAM-input config is used in CI (no overlap-alignment stage -> fast).
"""

import gzip
import os

import pytest

from raconx.models.polish_model import PolisherConfig, PolisherType
from raconx.polisher import create_polisher
from raconx.native import loader

if not loader.available():
    pytest.skip("native runtime unavailable", allow_module_level=True)

RC = bytes.maketrans(b"ACGT", b"TGCA")


def _fa(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        return b"".join(f.read().split(b"\n")[1:])


def test_polish_fastq_sam_beats_reference_golden(data_dir):
    from raconx.native import bindings
    cfg = PolisherConfig(backend="native", num_threads=4, match=5,
                         mismatch=-4, gap=-8)
    p = create_polisher(os.path.join(data_dir, "sample_reads.fastq.gz"),
                        os.path.join(data_dir, "sample_overlaps.sam.gz"),
                        os.path.join(data_dir, "sample_layout.fasta.gz"), cfg)
    p.initialize()
    out = p.polish(drop_unpolished_sequences=True)
    assert len(out) == 1
    name, data = out[0]
    assert name.startswith(b"utg000001l LN:i:")
    ref = _fa(os.path.join(data_dir, "sample_reference.fasta.gz"))
    dist = bindings.edit_distance(data[::-1].translate(RC), ref)
    # reference racon's own golden is 1317 (CPU) / 1541 (CUDA); we measured
    # 1127 in round 1 — keep a band that catches regressions
    assert dist < 1317, f"worse than reference racon golden: {dist}"
    assert dist <= 1220, f"regressed vs pinned round-1 quality: {dist}"


def test_polish_single_pass_mode(data_dir):
    """--refine-passes 1 must still work (plain star-POA)."""
    cfg = PolisherConfig(backend="native", num_threads=4, match=5,
                         mismatch=-4, gap=-8, refine_passes=1)
    p = create_polisher(os.path.join(data_dir, "sample_reads.fastq.gz"),
                        os.path.join(data_dir, "sample_overlaps.sam.gz"),
                        os.path.join(data_dir, "sample_layout.fasta.gz"), cfg)
    p.initialize()
    out = p.polish(drop_unpolished_sequences=True)
    assert len(out) == 1


@pytest.mark.parametrize("reads,ovl,m,x,g,w,ref_golden", [
    ("sample_reads.fastq.gz", "sample_overlaps.paf.gz", 5, -4, -8, 500, 1312),
    ("sample_reads.fasta.gz", "sample_overlaps.paf.gz", 5, -4, -8, 500, 1566),
    ("sample_reads.fasta.gz", "sample_overlaps.sam.gz", 5, -4, -8, 500, 1770),
    ("sample_reads.fastq.gz", "sample_overlaps.paf.gz", 1, -1, -1, 500, 1321),
    ("sample_reads.fastq.gz", "sample_overlaps.paf.gz", 5, -4, -8, 1000, 1289),
])
def test_full_golden_matrix_beats_reference(data_dir, reads, ovl, m, x, g, w,
                                            ref_golden):
    """All remaining reference golden configs (test/racon_test.cpp:88-218):
    our consensus must beat the reference's own pinned edit distance.
    In the default suite since the Myers/WFA host aligner (round 2) made
    the overlap-alignment stage seconds-fast on CPU."""
    from raconx.native import bindings
    cfg = PolisherConfig(backend="auto", num_threads=os.cpu_count() or 4,
                         match=m, mismatch=x, gap=g, window_length=w)
    p = create_polisher(os.path.join(data_dir, reads),
                        os.path.join(data_dir, ovl),
                        os.path.join(data_dir, "sample_layout.fasta.gz"), cfg)
    p.initialize()
    out = p.polish(drop_unpolished_sequences=True)
    assert len(out) == 1
    ref = _fa(os.path.join(data_dir, "sample_reference.fasta.gz"))
    dist = bindings.edit_distance(out[0][1][::-1].translate(RC), ref)
    assert dist < ref_golden, (
        f"worse than reference racon golden {ref_golden}: {dist}")
