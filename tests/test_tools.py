"""Companion tools: rampler subsample/split, preprocess, wrapper CLI.

Reference behavior: vendor/rampler as used by scripts/racon_wrapper.py:62-111
(output naming <base>_<cov>x.<ext> / <base>_<i>.<ext>), and
scripts/racon_preprocess.py:11-60 (1/2 header suffixes)."""

import gzip
import io
import os

import numpy as np
import pytest

from raconx.tools import preprocess, rampler


@pytest.fixture
def fastq_file(tmp_path):
    rng = np.random.default_rng(3)
    path = tmp_path / "reads.fastq"
    with open(path, "wb") as f:
        for i in range(40):
            data = rng.choice(np.frombuffer(b"ACGT", np.uint8), 100).tobytes()
            f.write(b"@read%d\n%s\n+\n%s\n" % (i, data, b"I" * 100))
    return str(path)


def test_split_chunks_and_naming(fastq_file, tmp_path):
    out = rampler.split(fastq_file, 1000, str(tmp_path))
    # 40 x 100bp into <=1000-byte chunks -> 4 files of 10 records
    assert [os.path.basename(p) for p in out] == [
        f"reads_{i}.fastq" for i in range(4)]
    total = 0
    for p in out:
        lines = open(p, "rb").read().split(b"\n")
        recs = (len(lines) - 1) // 4
        assert sum(len(lines[4 * r + 1]) for r in range(recs)) <= 1000
        total += recs
    assert total == 40


def test_split_oversized_record_gets_own_chunk(tmp_path):
    path = tmp_path / "seqs.fasta"
    path.write_bytes(b">a\n" + b"A" * 500 + b"\n>b\n" + b"C" * 50 + b"\n")
    out = rampler.split(str(path), 100, str(tmp_path))
    assert len(out) == 2
    assert b"A" * 500 in open(out[0], "rb").read()


def test_subsample_expected_coverage(fastq_file, tmp_path):
    # ref_len 400, coverage 5 -> expect ~2000 of 4000 bases
    out = rampler.subsample(fastq_file, 400, ["5"], str(tmp_path), seed=11)
    assert os.path.basename(out[0]) == "reads_5x.fastq"
    lines = open(out[0], "rb").read().split(b"\n")
    n_bases = sum(len(lines[i]) for i in range(1, len(lines), 4))
    assert 1000 <= n_bases <= 3000
    # fastq record shape preserved (name/data/+/quality)
    assert lines[0].startswith(b"@read") and lines[2] == b"+"


def test_subsample_cap_at_full_input(fastq_file, tmp_path):
    out = rampler.subsample(fastq_file, 4000, ["100"], str(tmp_path), seed=1)
    lines = open(out[0], "rb").read().split(b"\n")
    assert (len(lines) - 1) // 4 == 40  # p capped at 1 -> everything kept


def test_subsample_gzip_input_plain_output(tmp_path):
    path = tmp_path / "seqs.fasta.gz"
    with gzip.open(path, "wb") as f:
        f.write(b">s1\nACGTACGT\n>s2\nTTTT\n")
    out = rampler.subsample(str(path), 12, ["1"], str(tmp_path), seed=0)
    assert os.path.basename(out[0]) == "seqs_1x.fasta"
    assert open(out[0], "rb").read() == b">s1\nACGTACGT\n>s2\nTTTT\n"


def test_preprocess_pairs_get_1_2_suffixes(tmp_path):
    p1 = tmp_path / "r1.fastq"
    p1.write_text("@p extra\nACGT\n+\nIIII\n@q\nGG\n+\nII\n")
    p2 = tmp_path / "r2.fastq"
    p2.write_text("@p\nTTTT\n+\nIIII\n")
    seen: set = set()
    out = io.StringIO()
    preprocess.parse_file(str(p1), seen, out)
    preprocess.parse_file(str(p2), seen, out)
    assert out.getvalue() == ("@p1\nACGT\n+\nIIII\n@q1\nGG\n+\nII\n"
                              "@p2\nTTTT\n+\nIIII\n")


def test_preprocess_multiline_records(tmp_path):
    p = tmp_path / "r.fastq"
    p.write_text("@m\nAC\nGT\n+\nII\nII\n")
    seen: set = set()
    out = io.StringIO()
    preprocess.parse_file(str(p), seen, out)
    assert out.getvalue() == "@m1\nACGT\n+\nIIII\n"


def test_wrapper_split_run(tmp_path, monkeypatch, capfdbinary):
    """Wrapper with --split polishes each target chunk sequentially."""
    rng = np.random.default_rng(5)
    ACGT = np.frombuffer(b"ACGT", np.uint8)
    monkeypatch.chdir(tmp_path)
    true = rng.choice(ACGT, 2000)
    draft = true.copy()
    for pos in rng.choice(2000, 30, replace=False):
        draft[pos] = rng.choice(ACGT)
    reads, paf = [], []
    for ctg in range(2):
        base = 1000 * ctg
        for r in range(12):
            s = base + (r % 4) * 200
            e = min(base + 1000, s + 600)
            read = true[s:e].copy()
            rid = f"read{ctg}_{r}".encode()
            reads.append(b">%s\n%s\n" % (rid, read.tobytes()))
            paf.append(b"\t".join([
                rid, b"%d" % len(read), b"0", b"%d" % len(read), b"+",
                b"ctg%d" % ctg, b"1000", b"%d" % (s - base), b"%d" % (e - base),
                b"9", b"9", b"255"]) + b"\n")
    (tmp_path / "reads.fasta").write_bytes(b"".join(reads))
    (tmp_path / "ovl.paf").write_bytes(b"".join(paf))
    (tmp_path / "draft.fasta").write_bytes(
        b">ctg0\n" + draft[:1000].tobytes() + b"\n>ctg1\n"
        + draft[1000:].tobytes() + b"\n")

    from raconx.tools import wrapper
    rc = wrapper.main(["--split", "1000", "-t", "2", "--backend", "native",
                       "reads.fasta", "ovl.paf", "draft.fasta"])
    assert rc == 0
    out, err = capfdbinary.readouterr()
    assert b"total number of splits: 2" in err
    recs = [r for r in out.split(b">") if r]
    assert len(recs) == 2
    names = sorted(r.split(b"\n")[0].split(b" ")[0] for r in recs)
    assert names == [b"ctg0", b"ctg1"]
    # polished output matches the truth (easy, error-free reads)
    for r in recs:
        name = r.split(b"\n")[0].split(b" ")[0]
        seq = r.split(b"\n", 1)[1].replace(b"\n", b"")
        span = true[:1000] if name == b"ctg0" else true[1000:]
        assert seq == span.tobytes()
    # work directory cleaned up
    assert not [d for d in os.listdir(tmp_path)
                if d.startswith("racon_work_directory_")]
