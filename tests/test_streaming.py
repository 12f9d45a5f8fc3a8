"""Chunked streaming overlap parse + in-stream filtering.

The reference parses overlaps in 1 GiB chunks with in-stream filtering and
defers the query-run that straddles a chunk boundary
(src/polisher.cpp:26,310-355). These tests force tiny chunks and assert the
pipeline output is invariant to the chunk size, plus pin the exact
sequential-elimination semantics of the kC longest-overlap scan
(src/polisher.cpp:284-308)."""

import gzip
import os

import numpy as np
import pytest

from raconx.core.overlaps import OverlapTable, _kc_scan
from raconx.io.sniff import open_overlap_parser
from raconx.native import loader


def test_kc_scan_reference_semantics():
    # bad records compete for "longest" until the scan reaches them:
    # [A ok len10, B bad len12, C ok len8] -> B kills A, B dropped as bad,
    # C survives (NOT A)
    keep = _kc_scan(np.array([10, 12, 8]), np.array([False, True, False]))
    assert list(keep) == [False, False, True]
    # tie -> later record wins
    keep = _kc_scan(np.array([5, 7, 7, 3]), np.zeros(4, bool))
    assert list(keep) == [False, False, True, False]
    # bad champion kills everything then dies -> empty run
    keep = _kc_scan(np.array([5, 12]), np.array([False, True]))
    assert list(keep) == [False, False]
    # all-bad run
    keep = _kc_scan(np.array([5]), np.array([True]))
    assert list(keep) == [False]


@pytest.mark.skipif(not loader.available(), reason="native runtime required")
def test_stream_chunks_cover_whole_file(data_dir, tmp_path):
    path = os.path.join(data_dir, "sample_ava_overlaps.paf.gz")
    parser = open_overlap_parser(path)
    whole = parser.parse()
    chunks = list(open_overlap_parser(path).parse_chunks(16 * 1024))
    assert len(chunks) > 5  # tiny chunk size -> many chunks
    merged = OverlapTable.concat(chunks)
    assert len(merged) == len(whole)
    assert merged.q_names == whole.q_names
    np.testing.assert_array_equal(merged.q_begin, whole.q_begin)
    np.testing.assert_array_equal(merged.t_end, whole.t_end)
    np.testing.assert_array_equal(merged.strand, whole.strand)
    np.testing.assert_array_equal(merged.error, whole.error)


@pytest.mark.skipif(not loader.available(), reason="native runtime required")
def test_filtering_invariant_to_chunk_size(data_dir):
    """The kC-filtered overlap set must not depend on the parse chunk size,
    even when query runs straddle chunk boundaries (the polisher's carry
    loop defers the open trailing run, like the reference's c/l
    bookkeeping)."""
    from raconx.core.store import SequenceStoreBuilder
    from raconx.io.sniff import open_sequence_parser

    reads = open_sequence_parser(
        os.path.join(data_dir, "sample_reads.fastq.gz")).parse_store()
    name_to_id = {}
    id_to_id = {}
    for i in range(len(reads)):
        name_to_id[reads.names[i] + b"q"] = i
        name_to_id[reads.names[i] + b"t"] = i
        id_to_id[i << 1 | 0] = i
        id_to_id[i << 1 | 1] = i

    path = os.path.join(data_dir, "sample_ava_overlaps.paf.gz")

    def run(chunk_bytes):
        kept = []
        carry = None
        for chunk in open_overlap_parser(path).parse_chunks(chunk_bytes):
            chunk.transmute(reads, name_to_id, id_to_id)
            work = OverlapTable.concat([carry, chunk]) if carry else chunk
            head, carry = work.split_at(work.trailing_run_start())
            keep = head.filter_invalid(0.3, keep_longest_per_query=True)
            head.compact(keep)
            kept.append(head)
        if carry is not None:
            keep = carry.filter_invalid(0.3, keep_longest_per_query=True)
            carry.compact(keep)
            kept.append(carry)
        return OverlapTable.concat(kept)

    small = run(8 * 1024)      # many chunks, split runs
    big = run(1 << 30)         # single chunk
    assert len(small) == len(big) > 0
    np.testing.assert_array_equal(small.q_id, big.q_id)
    np.testing.assert_array_equal(small.t_id, big.t_id)
    np.testing.assert_array_equal(small.length, big.length)


@pytest.mark.skipif(not loader.available(), reason="native runtime required")
@pytest.mark.parametrize("fname,is_fastq", [
    ("sample_reads.fasta.gz", False),
    ("sample_reads.fastq.gz", True),
])
def test_fastx_stream_invariant_to_chunk_size(data_dir, fname, is_fastq,
                                              monkeypatch):
    """SequenceStore built from tiny stream chunks must equal the
    whole-file parse, including multi-record carries cut mid-record."""
    from raconx.io.sniff import open_sequence_parser

    path = os.path.join(data_dir, fname)
    whole = open_sequence_parser(path).parse_store()
    monkeypatch.setenv("RACONX_CHUNK_BYTES", "4096")
    small = open_sequence_parser(path).parse_store()
    assert small.names == whole.names
    np.testing.assert_array_equal(small.blob, whole.blob)
    np.testing.assert_array_equal(small.data_off, whole.data_off)
    np.testing.assert_array_equal(small.qual_blob, whole.qual_blob)
    np.testing.assert_array_equal(small.qual_off, whole.qual_off)


@pytest.mark.skipif(not loader.available(), reason="native runtime required")
def test_fastq_stream_every_cut_position(tmp_path):
    """Regression: a chunk boundary right after a FASTQ header used to
    commit a bogus empty record and fail the next chunk as malformed.
    Sweep every cut position over a small file."""
    from raconx.native import bindings

    path = str(tmp_path / "two.fastq")
    body = (b"@read1 extra\nACGTAC\nGT\n+\n!!!!!!!!\n"
            b"@read2\nTTTT\n+\nHHHH\n")
    with open(path, "wb") as f:
        f.write(body)
    for cut in range(1, len(body) + 2):
        names, name_off, data, data_off, quals, qual_off = [], None, [], None, [], None
        recs = []
        for r in bindings.fastx_stream(path, True, cut):
            nb, no = r[0].tobytes(), r[1]
            db, do = r[2].tobytes(), r[3]
            for i in range(len(no) - 1):
                recs.append((nb[no[i]:no[i+1]], db[do[i]:do[i+1]]))
        assert recs == [(b"read1", b"ACGTACGT"), (b"read2", b"TTTT")], cut


def test_split_and_trailing_run():
    t = OverlapTable()
    t.finalize_from_lists({
        "q_names": [b"a", b"a", b"b", b"b"],
        "t_names": [b"x"] * 4,
        "q_begin": [0] * 4, "q_end": [10] * 4,
        "q_length": [10] * 4, "t_begin": [0] * 4, "t_end": [10] * 4,
        "t_length": [10] * 4, "length": [10] * 4,
        "strand": [False] * 4, "error": [0.0] * 4,
    })
    t.q_id = np.array([0, 0, 1, 1])
    t.is_valid = np.ones(4, bool)
    assert t.trailing_run_start() == 2
    head, tail = t.split_at(2)
    assert len(head) == 2 and len(tail) == 2
    assert tail.q_names == [b"b", b"b"]
    merged = OverlapTable.concat([head, tail])
    assert merged.q_names == t.q_names
