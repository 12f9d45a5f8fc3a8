"""Wrapper CLI — scale-out by subsampling/splitting.

Reference: scripts/racon_wrapper.py. Same surface: racon's arguments plus
--split <bytes> (targets split into chunks, polished sequentially to bound
memory, :85-117,134-144) and --subsample <ref_len> <coverage> (reads
subsampled to the requested coverage, :60-83); temp work directory lifecycle
(:41-55); wrapper-specific score defaults m=5 x=-4 g=-8 (:184-189). The
polishing itself runs in-process through the same Polisher the racon CLI
uses (the reference shells out to the racon binary; there is no separate
binary here), one chunk at a time so peak memory stays bounded.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

from ..errors import RaconError
from ..models.polish_model import PolisherConfig, PolisherType
from ..polisher import create_polisher
from . import rampler


def eprint(*args):
    print(*args, file=sys.stderr, flush=True)


class RaconWrapper:
    def __init__(self, args):
        self.args = args
        self.sequences = os.path.abspath(args.sequences)
        self.overlaps = os.path.abspath(args.overlaps)
        self.target_sequences = os.path.abspath(args.target_sequences)
        self.work_directory = (os.getcwd() + "/racon_work_directory_" +
                               str(time.time()))

    def __enter__(self):
        try:
            os.makedirs(self.work_directory, exist_ok=True)
        except OSError:
            eprint("[RaconWrapper::__enter__] error: unable to create work "
                   "directory!")
            sys.exit(1)
        return self

    def __exit__(self, exc_type, exc_value, tb):
        try:
            shutil.rmtree(self.work_directory)
        except OSError:
            eprint("[RaconWrapper::__exit__] warning: unable to clean work "
                   "directory!")

    def _config(self) -> PolisherConfig:
        a = self.args
        return PolisherConfig(
            type=PolisherType.kF if a.fragment_correction else PolisherType.kC,
            window_length=int(a.window_length),
            quality_threshold=float(a.quality_threshold),
            error_threshold=float(a.error_threshold),
            match=int(a.match), mismatch=int(a.mismatch), gap=int(a.gap),
            num_threads=int(a.threads), backend=a.backend)

    def run(self) -> None:
        a = self.args
        eprint("[RaconWrapper::run] preparing data with rampler")
        sequences = self.sequences
        if a.subsample is not None:
            ref_len, coverage = a.subsample
            try:
                paths = rampler.subsample(self.sequences, int(ref_len),
                                          [coverage], self.work_directory)
            except RaconError as e:
                eprint(e.message)
                sys.exit(1)
            sequences = paths[0]
            if not os.path.isfile(sequences):
                eprint("[RaconWrapper::run] error: unable to find subsampled "
                       "sequences!")
                sys.exit(1)

        if a.split is not None:
            try:
                targets = rampler.split(self.target_sequences, int(a.split),
                                        self.work_directory)
            except RaconError as e:
                eprint(e.message)
                sys.exit(1)
            eprint("[RaconWrapper::run] total number of splits: "
                   + str(len(targets)))
            if not targets:
                eprint("[RaconWrapper::run] error: unable to find split "
                       "target sequences!")
                sys.exit(1)
        else:
            targets = [self.target_sequences]

        out = sys.stdout.buffer
        for target_part in targets:
            eprint("[RaconWrapper::run] processing data with racon")
            try:
                polisher = create_polisher(sequences, self.overlaps,
                                           target_part, self._config())
                polisher.initialize()
                polished = polisher.polish(not a.include_unpolished)
            except RaconError as e:
                eprint(e.message)
                sys.exit(1)
            for name, data in polished:
                out.write(b">" + name + b"\n" + data + b"\n")
            out.flush()
            del polisher, polished


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="racon_wrapper",
        description="""Racon_wrapper encapsulates racon and adds two
        additional features: sequences can be subsampled to decrease the
        total execution time (accuracy might be lower) while target sequences
        can be split into smaller chunks and run sequentially to decrease
        memory consumption. Both features can be run at the same time!""",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("sequences", help="input file in FASTA/FASTQ format "
                        "(can be compressed with gzip) containing sequences "
                        "used for correction")
    parser.add_argument("overlaps", help="input file in MHAP/PAF/SAM format "
                        "(can be compressed with gzip) containing overlaps "
                        "between sequences and target sequences")
    parser.add_argument("target_sequences", help="input file in FASTA/FASTQ "
                        "format (can be compressed with gzip) containing "
                        "sequences which will be corrected")
    parser.add_argument("--split", help="split target sequences into chunks "
                        "of desired size in bytes")
    parser.add_argument("--subsample", nargs=2,
                        metavar=("REFERENCE_LENGTH", "COVERAGE"),
                        help="subsample sequences to desired coverage (2nd "
                        "argument) given the reference length (1st argument)")
    parser.add_argument("-u", "--include-unpolished", action="store_true",
                        help="output unpolished target sequences")
    parser.add_argument("-f", "--fragment-correction", action="store_true",
                        help="perform fragment correction instead of contig "
                        "polishing (overlaps file should contain dual/self "
                        "overlaps!)")
    parser.add_argument("-w", "--window-length", default=500,
                        help="size of window on which POA is performed")
    parser.add_argument("-q", "--quality-threshold", default=10.0,
                        help="threshold for average base quality of windows "
                        "used in POA")
    parser.add_argument("-e", "--error-threshold", default=0.3,
                        help="maximum allowed error rate used for filtering "
                        "overlaps")
    parser.add_argument("-m", "--match", default=5,
                        help="score for matching bases")
    parser.add_argument("-x", "--mismatch", default=-4,
                        help="score for mismatching bases")
    parser.add_argument("-g", "--gap", default=-8,
                        help="gap penalty (must be negative)")
    parser.add_argument("-t", "--threads", default=1,
                        help="number of threads")
    parser.add_argument("--backend", default="auto",
                        help="compute backend: auto, gpu, native, python")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    with RaconWrapper(args) as w:
        w.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
