"""seqwin_tpu_torch: the minimizer-graph build of seqwin-tpu in PyTorch, for
one NVIDIA H100.

Counterpart: `seqwin_tpu/__init__.py`. This package imports torch and numpy
only, never JAX or `seqwin_tpu`; it keeps its own copies of the constants,
dtypes and host code it needs. Its entry points run on the GPU unless the
caller passes ``device='cpu'``. The phase-1 minimizer scan runs in CUDA
kernels written for sm_90a (`csrc/phase1.cu`: z, z with hashes, tile
staircases), built with nvcc at first use.

Ported so far: `graph.build` / `graph.build_deferred`, on one device or
sharded over the cards of one host (``devices=N``,
`parallel.build_distributed`). The pipeline, CLI and markers are still to
come (ROADMAP A7).
"""
from . import graph  # noqa: F401
