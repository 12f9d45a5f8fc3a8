"""racon-compatible CLI (reference: src/main.cpp). Same positional arguments,
options, defaults, stdout FASTA contract, and error messages; adds
framework-specific options (--backend, device batching caps); racon's CUDA
options select the GPU backend."""

from __future__ import annotations

import argparse
import sys

from . import RACON_VERSION
from .errors import RaconError
from .models.polish_model import PolisherConfig, PolisherType
from .polisher import create_polisher

HELP = """usage: racon [options ...] <sequences> <overlaps> <target sequences>

    #default output is stdout
    <sequences>
        input file in FASTA/FASTQ format (can be compressed with gzip)
        containing sequences used for correction
    <overlaps>
        input file in MHAP/PAF/SAM format (can be compressed with gzip)
        containing overlaps between sequences and target sequences
    <target sequences>
        input file in FASTA/FASTQ format (can be compressed with gzip)
        containing sequences which will be corrected

    options:
        -u, --include-unpolished
            output unpolished target sequences
        -f, --fragment-correction
            perform fragment correction instead of contig polishing
            (overlaps file should contain dual/self overlaps!)
        -w, --window-length <int>
            default: 500
            size of window on which POA is performed
        -q, --quality-threshold <float>
            default: 10.0
            threshold for average base quality of windows used in POA
        -e, --error-threshold <float>
            default: 0.3
            maximum allowed error rate used for filtering overlaps
        --no-trimming
            disables consensus trimming at window ends
        -m, --match <int>
            default: 3
            score for matching bases
        -x, --mismatch <int>
            default: -5
            score for mismatching bases
        -g, --gap <int>
            default: -4
            gap penalty (must be negative)
        -t, --threads <int>
            default: 1
            number of threads
        --backend <str>
            default: auto
            compute backend: auto (gpu when JAX finds one, else native),
            gpu, native, python
        --band-width <int>
            default: 0 (auto: 10%% of mean overlap length)
            band width for device overlap alignment
        --max-window-depth <int>
            default: 200
            maximum layers per window on the device path
        --refine-passes <int>
            default: 4
            iterative consensus refinement passes (1 = single-pass POA)
        --candidate-frac <float> / --candidate-min <int>
            default: 0.15 / 2
            support thresholds for insertion candidates between passes
        --profile <dir>
            write a JAX/XLA profiler trace to <dir> (view with TensorBoard)
        --distributed
            multi-host run: initialize jax.distributed from the standard
            environment (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
            JAX_PROCESS_ID), shard overlap alignment and window consensus
            per process, gather to process 0 for output; processes that
            share a machine take one of its GPUs each, in process-id order
            (also enabled by RACONX_DISTRIBUTED=1)
        --version
            prints the version number
        -h, --help
            prints the usage

    accepted for drop-in compatibility with racon's CUDA build (they select
    the gpu backend; batch counts are managed automatically):
        -c, --cudapoa-batches <int>
            default: 0
            number of batches for CUDA accelerated polishing
        -b, --cuda-banded-alignment
            use banding approximation for polishing on GPU. Only applicable
            when -c is used.
        --cudaaligner-batches <int>
            default: 0
            number of batches for CUDA accelerated alignment
        --cudaaligner-band-width <int>
            default: 0
            band width for cuda alignment (0 = auto band width)
"""


def build_config(args) -> PolisherConfig:
    # racon's CUDA flags request the accelerator path (src/main.cpp:37-40)
    backend = args.backend
    cuda = (args.cudapoa_batches or args.cuda_banded_alignment
            or args.cudaaligner_batches)
    if backend == "auto" and cuda:
        backend = "gpu"
    band = args.band_width or args.cudaaligner_band_width
    return PolisherConfig(
        type=PolisherType.kF if args.fragment_correction else PolisherType.kC,
        window_length=args.window_length,
        quality_threshold=args.quality_threshold,
        error_threshold=args.error_threshold,
        trim=not args.no_trimming,
        match=args.match,
        mismatch=args.mismatch,
        gap=args.gap,
        num_threads=args.threads,
        backend=backend,
        band_width=band,
        max_window_depth=args.max_window_depth,
        refine_passes=args.refine_passes,
        candidate_frac=args.candidate_frac,
        candidate_min=args.candidate_min,
    )


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("-u", "--include-unpolished", action="store_true")
    parser.add_argument("-f", "--fragment-correction", action="store_true")
    parser.add_argument("-w", "--window-length", type=int, default=500)
    parser.add_argument("-q", "--quality-threshold", type=float, default=10.0)
    parser.add_argument("-e", "--error-threshold", type=float, default=0.3)
    parser.add_argument("--no-trimming", action="store_true")
    parser.add_argument("-m", "--match", type=int, default=3)
    parser.add_argument("-x", "--mismatch", type=int, default=-5)
    parser.add_argument("-g", "--gap", type=int, default=-4)
    parser.add_argument("-t", "--threads", type=int, default=1)
    parser.add_argument("--backend", type=str, default="auto")
    parser.add_argument("--band-width", type=int, default=0)
    parser.add_argument("--max-window-depth", type=int, default=200)
    parser.add_argument("--refine-passes", type=int, default=4)
    parser.add_argument("--candidate-frac", type=float, default=0.15)
    parser.add_argument("--candidate-min", type=int, default=2)
    parser.add_argument("--profile", type=str, default="",
                        metavar="DIR")  # JAX/XLA trace -> DIR (TensorBoard)
    parser.add_argument("--distributed", action="store_true")
    # drop-in aliases for racon's CUDA options (src/main.cpp:37-40): they
    # request the gpu backend; batch sizing is automatic, so the counts
    # only act as an on/off switch
    parser.add_argument("-c", "--cudapoa-batches", type=int, nargs="?",
                        const=1, default=0)
    parser.add_argument("-b", "--cuda-banded-alignment", action="store_true")
    parser.add_argument("--cudaaligner-batches", type=int, default=0)
    parser.add_argument("--cudaaligner-band-width", type=int, default=0)
    parser.add_argument("--version", action="store_true")
    parser.add_argument("-h", "--help", action="store_true")
    parser.add_argument("inputs", nargs="*")

    try:
        args = parser.parse_args(argv)
    except SystemExit:
        return 1

    if args.version:
        # the racon contract version this CLI implements (main.cpp:143-145)
        print(f"v{RACON_VERSION}")
        return 0
    if args.help:
        print(HELP, end="")
        return 0
    if len(args.inputs) < 3:
        sys.stderr.write("[racon::] error: missing input file(s)!\n")
        print(HELP, end="")
        return 1

    cfg = build_config(args)
    import os as _os
    out_stream = None
    if args.distributed or _os.environ.get("RACONX_DISTRIBUTED") == "1":
        # collective backends (gloo on CPU) print connection banners to
        # fd 1, which would corrupt the FASTA stream: keep a private
        # handle to the REAL stdout for our output and point fd 1 at
        # stderr so library chatter lands there instead
        try:
            real = _os.dup(1)
            _os.dup2(2, 1)
            out_stream = _os.fdopen(real, "wb")
        except OSError:
            out_stream = None
        # must come up before any device use so the mesh spans every host
        from .parallel import dist
        dist.initialize()
    profiler = None
    if args.profile:
        # structured device+host tracing (view with TensorBoard); the
        # reference's nvprof hook analog (src/cuda/cudapolisher.cpp:10,71)
        try:
            import jax.profiler as profiler
            profiler.start_trace(args.profile)
        except Exception as e:
            sys.stderr.write(f"[racon::] warning: profiler unavailable: {e}\n")
            profiler = None

    try:
        from .backends import use_device

        use_device(cfg)  # fail fast on an unusable backend choice
        polisher = create_polisher(args.inputs[0], args.inputs[1],
                                   args.inputs[2], cfg)
        polisher.initialize()
        polished = polisher.polish(not args.include_unpolished)
    except RaconError as e:
        sys.stderr.write(e.message + "\n")
        return 1
    finally:
        if profiler is not None:
            try:
                profiler.stop_trace()
            except Exception:
                pass

    out = out_stream if out_stream is not None else sys.stdout.buffer
    for name, data in polished:
        out.write(b">" + name + b"\n" + data + b"\n")
    out.flush()
    polisher.total()
    return 0


def run() -> None:
    """Process entry point (console script / python -m): exit the instant
    the output is flushed, as the C++ CLI does (reference:
    src/main.cpp:167), without waiting on interpreter teardown of the
    runtime's worker threads. In-process callers (tests, the wrapper) use
    main(), which returns normally."""
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    import os

    os._exit(rc)


if __name__ == "__main__":
    run()
