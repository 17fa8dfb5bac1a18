"""seqwin_tpu_torch: the minimizer-graph build of seqwin-tpu in PyTorch, for
one NVIDIA H100.

Counterpart: `seqwin_tpu/__init__.py`. This package imports torch and numpy
only, never JAX or `seqwin_tpu`; it keeps its own copies of the constants,
dtypes and host code it needs. Its entry points run on the GPU unless the
caller passes ``device='cpu'``. The phase-1 minimizer scan runs in a CUDA
kernel written for sm_90a (`csrc/phase1_z.cu`), built with nvcc at first use.

Ported so far: `graph.build` / `graph.build_deferred` (the single-device
main path). The pipeline, CLI and markers are still to come (ROADMAP A7).
"""
from . import graph  # noqa: F401
