"""Vectorized host-side ntHash for sparse position sets.

Counterpart: `seqwin_tpu/ops/host_hash.py` (copied). Computes canonical
hashes for arbitrary k-mer positions with table lookups -- used by the chunk
scan to resolve irregular windows on the host. Exact u64 arithmetic:

    canon(p) = (XOR_j srol^{k-1-j}(SEED[s_{p+j}])  +
                XOR_j srol^{j}(SEED_COMP[s_{p+j}])) mod 2^64
"""
from __future__ import annotations

import numpy as np

from .hashing import SEEDS, SEEDS_COMP, srol

_table_cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}


def _tables(k: int) -> tuple[np.ndarray, np.ndarray]:
    """(fwd[k, 5], rev[k, 5]) rotated seed tables; column 4 = invalid (0)."""
    cached = _table_cache.get(k)
    if cached is not None:
        return cached
    fwd = np.zeros((k, 5), dtype=np.uint64)
    rev = np.zeros((k, 5), dtype=np.uint64)
    for j in range(k):
        for c in range(4):
            fwd[j, c] = srol(SEEDS[c], (k - 1 - j) % 1023)
            rev[j, c] = srol(SEEDS_COMP[c], j % 1023)
    _table_cache[k] = (fwd, rev)
    return fwd, rev


def _canon_from_codes(c: np.ndarray, k: int) -> np.ndarray:
    fwd_tab, rev_tab = _tables(k)
    fwd = np.bitwise_xor.reduce(fwd_tab[np.arange(k)[None, :], c], axis=1)
    rev = np.bitwise_xor.reduce(rev_tab[np.arange(k)[None, :], c], axis=1)
    return fwd + rev  # u64 wraps


def canon_at(codes: np.ndarray, positions: np.ndarray, k: int) -> np.ndarray:
    """Canonical ntHash of the k-mers starting at ``positions`` (all of which
    must be valid, i.e. k in-bounds ACGT bases). Uses the C loop
    (`io/native::canon_at`) when it builds, else NumPy gathers."""
    if len(positions) == 0:
        return np.zeros(0, dtype=np.uint64)
    from ..io import native

    fwd_tab, rev_tab = _tables(k)
    out = native.canon_at(codes, positions, k, fwd_tab, rev_tab, packed=False)
    if out is not None:
        return out
    offs = positions[:, None].astype(np.int64) + np.arange(k, dtype=np.int64)[None, :]
    # strip the record-start flag (bit 6); anything non-ACGT clamps to col 4
    c = np.minimum(codes[offs] & np.uint8(63), 4).astype(np.int64)
    return _canon_from_codes(c, k)


def canon_at_packed(packed: np.ndarray, positions: np.ndarray, k: int) -> np.ndarray:
    """Like `canon_at` but reading a 2-bit packed stream (4 bases/byte).
    All referenced positions must be valid ACGT bases."""
    if len(positions) == 0:
        return np.zeros(0, dtype=np.uint64)
    from ..io import native

    fwd_tab, rev_tab = _tables(k)
    out = native.canon_at(packed, positions, k, fwd_tab, rev_tab, packed=True)
    if out is not None:
        return out
    offs = positions[:, None].astype(np.int64) + np.arange(k, dtype=np.int64)[None, :]
    c = ((packed[offs >> 2] >> ((offs & 3) * 2).astype(np.uint8)) & np.uint8(3)).astype(np.int64)
    return _canon_from_codes(c, k)
