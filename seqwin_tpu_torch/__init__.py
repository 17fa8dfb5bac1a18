"""seqwin_tpu_torch: seqwin-tpu in PyTorch, for NVIDIA H100 GPUs.

Counterpart: `seqwin_tpu/__init__.py`. This package imports torch and numpy
only, never JAX, `seqwin_tpu`, pandas or pydantic; it keeps its own copies
of the constants, dtypes and host code it needs. Its entry points run on
the GPU unless the caller asks for the CPU (``device='cpu'``,
`Config.device`). The phase-1 minimizer scan runs in CUDA kernels written
for sm_90a (`csrc/phase1.cu`: z, z with hashes, tile staircases), built
with nvcc at first use.

The whole pipeline is ported: `run(Config(...))` and the CLI
(``python -m seqwin_tpu_torch``) go from FASTAs to `signatures.fasta` /
`.csv` through `graph.build_deferred`, on one card or sharded over the
cards of one host (``devices=N``, `parallel.build_distributed`).
"""
from . import graph  # noqa: F401
from ._version import __version__  # noqa: F401
from .config import Config  # noqa: F401
from .core import Seqwin, load, run  # noqa: F401
