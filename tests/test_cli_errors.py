"""CLI death tests: the reference's five error-path gtest death tests
(test/racon_test.cpp:55-86) — invalid polisher type, zero window length, and
an unsupported extension for each of the three inputs — asserting the exact
stderr message and a non-zero exit code through the real CLI entry point."""

import io
import sys
import contextlib

import pytest

from raconx import cli


def _run_cli(argv):
    """Run cli.main(argv) capturing stderr; returns (exit_code, stderr)."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        try:
            code = cli.main(argv)
        except SystemExit as e:  # argparse/usage paths
            code = e.code
    return code, err.getvalue()


def test_windows_length_error(tmp_path):
    # reference: PolisherCreateErrorWindowLength (racon_test.cpp:62-68)
    f = tmp_path / "x.fasta"
    f.write_text(">a\nACGT\n")
    o = tmp_path / "x.paf"
    o.write_text("")
    code, err = _run_cli(["-w", "0", str(f), str(o), str(f)])
    assert code != 0
    assert "[racon::createPolisher] error: invalid window length!" in err


def test_sequences_extension_error(tmp_path):
    # reference: PolisherCreateErrorSequencesPath (racon_test.cpp:70-76)
    bad = tmp_path / "reads.txt"
    bad.write_text("")
    ok = tmp_path / "t.fasta"
    ok.write_text(">a\nACGT\n")
    paf = tmp_path / "o.paf"
    paf.write_text("")
    code, err = _run_cli([str(bad), str(paf), str(ok)])
    assert code != 0
    assert ("[racon::createPolisher] error: file %s has unsupported format "
            "extension (valid extensions: .fasta, .fasta.gz, .fna, .fna.gz, "
            ".fa, .fa.gz, .fastq, .fastq.gz, .fq, .fq.gz)!" % bad) in err


def test_overlaps_extension_error(tmp_path):
    # reference: PolisherCreateErrorOverlapsPath (racon_test.cpp:78-81)
    ok = tmp_path / "t.fasta"
    ok.write_text(">a\nACGT\n")
    bad = tmp_path / "o.txt"
    bad.write_text("")
    code, err = _run_cli([str(ok), str(bad), str(ok)])
    assert code != 0
    assert ("[racon::createPolisher] error: file %s has unsupported format "
            "extension (valid extensions: .mhap, .mhap.gz, .paf, .paf.gz, "
            ".sam, .sam.gz)!" % bad) in err


def test_target_extension_error(tmp_path):
    # reference: PolisherCreateErrorTargetPath (racon_test.cpp:83-86)
    ok = tmp_path / "t.fasta"
    ok.write_text(">a\nACGT\n")
    paf = tmp_path / "o.paf"
    paf.write_text("")
    bad = tmp_path / "target.txt"
    bad.write_text("")
    code, err = _run_cli([str(ok), str(paf), str(bad)])
    assert code != 0
    assert ("[racon::createPolisher] error: file %s has unsupported format "
            "extension" % bad) in err


def test_invalid_type_error():
    # reference: PolisherCreateErrorType (racon_test.cpp:55-60); the CLI
    # cannot express an invalid type, so this goes through the factory like
    # the gtest does.
    from raconx.errors import RaconError
    from raconx.polisher import create_polisher, PolisherConfig

    with pytest.raises(RaconError,
                       match=r"\[racon::createPolisher\] error: invalid "
                             r"polisher type!"):
        create_polisher("a.fasta", "b.paf", "c.fasta",
                        PolisherConfig(type=3))


def test_version_flag(capsys):
    code, err = _run_cli(["--version"])
    assert code in (0, None)
