"""Multi-device graph build on one host.

Counterpart: `seqwin_tpu/parallel/__init__.py` and the single-host part of
`seqwin_tpu/parallel/distributed.py`.
"""
from .distributed import build_distributed, build_distributed_arrays, partition_records  # noqa: F401
