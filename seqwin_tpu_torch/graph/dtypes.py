"""NumPy structured dtypes of the minimizer-graph arrays.

Counterpart: `seqwin_tpu/graph/dtypes.py` (copied). The field layout is the
public output contract, so `graph.npz` files of both packages interchange.
"""
import numpy as np

KMER_DTYPE = np.dtype([
    ('pos', np.uint32),
    ('record_idx', np.uint32),
])

NODE_DTYPE = np.dtype([
    ('hash', np.uint64),
    ('start', np.uintp),
    ('stop', np.uintp),
    ('n_tar', np.uint32),
    ('n_neg', np.uint32),
    ('penalty', np.float64),
])

EDGE_DTYPE = np.dtype([
    ('first', np.uint64),
    ('second', np.uint64),
    ('weight', np.uintp),
])
