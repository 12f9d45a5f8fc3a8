"""raconx: GPU-accelerated long-read consensus / assembly polishing.

A from-scratch framework with the capabilities of racon (isovic/racon):
reads (FASTA/FASTQ[.gz]) + overlaps (MHAP/PAF/SAM[.gz]) + target contigs
in, polished contigs out, via windowed partial-order consensus. The compute
core is batched banded alignment on the GPU (CUDA kernels called from JAX)
plus a host-side C++ star-POA runtime; everything also runs CPU-only.
"""

__version__ = "0.2.0"

# racon CLI-contract version implemented by this framework; `racon --version`
# prints this for drop-in compatibility (reference: CMakeLists.txt:3 sets
# 1.4.17, printed by src/main.cpp:143-145)
RACON_VERSION = "1.4.17"

from .models.polish_model import PolisherConfig, PolisherType  # noqa: F401
from .polisher import Polisher, create_polisher  # noqa: F401
