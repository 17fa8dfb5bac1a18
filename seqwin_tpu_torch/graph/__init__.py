"""Minimizer-graph public API.

Counterpart: `seqwin_tpu/graph/__init__.py`.
"""
from .build import build, build_deferred, filter_kmers, kept_node_layout  # noqa: F401
from .dtypes import EDGE_DTYPE, KMER_DTYPE, NODE_DTYPE  # noqa: F401
from .hashgraph import HashGraph, OrderedKmers  # noqa: F401
