import os

import numpy as np
import pytest

from raconx.core.store import SequenceStoreBuilder
from raconx.io import fastx, overlaps_io, sniff
from raconx.errors import RaconError


def _load(path):
    b = SequenceStoreBuilder()
    sniff.open_sequence_parser(path).parse_into(b)
    return b.finish()


def test_fasta_targets(data_dir):
    store = _load(os.path.join(data_dir, "sample_layout.fasta.gz"))
    assert len(store) == 1
    assert store.name(0) == b"utg000001l"
    assert store.length(0) == 47564
    assert not store.has_quality(0)
    # uppercased ACGT alphabet
    assert set(np.unique(store.data(0))) <= set(b"ACGTN")


def test_fasta_reference(data_dir):
    store = _load(os.path.join(data_dir, "sample_reference.fasta.gz"))
    assert len(store) == 1
    assert store.length(0) == 48502


def test_fastq_reads(data_dir):
    store = _load(os.path.join(data_dir, "sample_reads.fastq.gz"))
    assert len(store) == 236
    assert all(store.has_quality(i) for i in range(len(store)))
    q = store.quality(0)
    assert len(q) == store.length(0)


def test_fasta_reads(data_dir):
    store = _load(os.path.join(data_dir, "sample_reads.fasta.gz"))
    assert len(store) == 236
    assert not any(store.has_quality(i) for i in range(len(store)))


def test_fasta_fastq_consistency(data_dir):
    fa = _load(os.path.join(data_dir, "sample_reads.fasta.gz"))
    fq = _load(os.path.join(data_dir, "sample_reads.fastq.gz"))
    assert [fa.name(i) for i in range(len(fa))] == \
        [fq.name(i) for i in range(len(fq))]
    assert fa.lengths().tolist() == fq.lengths().tolist()


def test_paf(data_dir):
    t = overlaps_io.parse_paf(os.path.join(data_dir, "sample_overlaps.paf.gz"))
    assert len(t) == 181
    assert all(n == b"utg000001l" for n in t.t_names)
    assert t.strand.sum() > 0
    assert np.all(t.error >= 0) and np.all(t.error <= 1)


def test_ava_paf(data_dir):
    t = overlaps_io.parse_paf(
        os.path.join(data_dir, "sample_ava_overlaps.paf.gz"))
    assert len(t) == 8016


def test_mhap(data_dir):
    t = overlaps_io.parse_mhap(
        os.path.join(data_dir, "sample_ava_overlaps.mhap.gz"))
    assert len(t) == 7780
    # 1-based ids converted
    assert t.q_id.min() >= 0 and t.t_id.min() >= 0


def test_sam(data_dir):
    t = overlaps_io.parse_sam(os.path.join(data_dir, "sample_overlaps.sam.gz"))
    assert len(t) > 0
    valid = t.is_valid
    # SAM: all valid records point at the single target
    assert all(t.t_names[i] == b"utg000001l"
               for i in range(len(t)) if valid[i])
    assert all(len(t.cigars[i]) >= 2 for i in range(len(t)) if valid[i])


def test_sniff_errors(tmp_path):
    with pytest.raises(RaconError, match="unsupported format"):
        sniff.open_sequence_parser("reads.txt")
    with pytest.raises(RaconError, match="unsupported format"):
        sniff.open_overlap_parser("overlaps.txt")


def test_quality_drop_rule(tmp_path):
    p = tmp_path / "x.fastq"
    p.write_bytes(b"@a\nACGT\n+\n!!!!\n@b\nACGT\n+\n!!!I\n")
    b = SequenceStoreBuilder()
    fastx.parse_fastq(str(p), b)
    store = b.finish()
    assert not store.has_quality(0)  # all-'!' dropped
    assert store.has_quality(1)


def test_fasta_multiline_and_case(tmp_path):
    p = tmp_path / "x.fasta"
    p.write_bytes(b">s1 desc here\nacgt\nACGT\n>s2\nTT\n")
    b = SequenceStoreBuilder()
    fastx.parse_fasta(str(p), b)
    store = b.finish()
    assert store.name(0) == b"s1"
    assert bytes(store.data(0)) == b"ACGTACGT"
    assert bytes(store.data(1)) == b"TT"
