"""
cutadapt-tpu on PyTorch and CUDA: the batch trimming engine of
``cutadapt_tpu`` ported to an NVIDIA GPU.

The banded semi-global aligner runs as a hand-written CUDA kernel
(``csrc/align_locate.cu``), the statistics reducer's binning as another
(``csrc/stats_scatter.cu``, ``parallel/stats.py``); with a device mesh
(``parallel/mesh.py``) every DP dispatch is sharded over several devices.
Byte-level host work (FASTQ parse, k-mer
prefilter, encode, assembly) is the C++ library in ``native/``. Entry
points take an explicit ``device`` argument: ``None`` means ``"cuda"``,
and ``"cpu"`` runs the kernel's plain PyTorch version.
"""

__version__ = "0.1.0"

# Version string reported in place of the reference's cutadapt version
# (the JSON report embeds it); the same as the JAX package's.
COMPAT_VERSION = "5.2"
