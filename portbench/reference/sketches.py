"""Upstream's Mash estimate of the threshold, with bottom-k MinHash sketches
in place of the `mash` tool (the port's ``--sketch-mode device``).

An assembly's sketch is the ``size`` least distinct canonical ntHash values
(unsigned) of the k-mers of its records, no k-mer spanning two records or an
invalid base, the all-ones value left out. The Jaccard index of two
sketches is Mash's: of the ``size`` least distinct values of their union,
the share found in both. The threshold takes, over the target-by-target
and the non-target-by-target blocks of the matrix, the mean of
``2J / (1 + J)``: one minus the first is the expected absence of a k-mer in
targets, the second its expected presence in non-targets.
"""
from __future__ import annotations

import numpy as np
import torch

from .minimizers import SIGN, canonical

ALL_ONES_KEY = (1 << 63) - 1  # the all-ones value, sign flipped


def sketch(records: list[np.ndarray], k: int, size: int, tables, device) -> np.ndarray:
    """uint64, ascending."""
    keys = [canonical(torch.from_numpy(c).to(device), k, tables)[0] ^ SIGN for c in records]
    keys = torch.unique(torch.cat(keys)) if keys else torch.zeros(0, dtype=torch.int64)
    keys = keys[keys != ALL_ONES_KEY][:size] ^ SIGN
    return keys.cpu().numpy().view(np.uint64)


def jaccard(a: np.ndarray, b: np.ndarray, size: int) -> float:
    union = np.union1d(a, b)[:size]
    if not len(union):
        return 0.0
    shared = np.count_nonzero(np.isin(union, a) & np.isin(union, b))
    return shared / len(union)


def expectations(sketches: list[np.ndarray], n_tar: int, size: int, dtype=np.float64):
    """(expected absence in targets, expected presence in non-targets)."""
    n = len(sketches)
    mtx = np.zeros((n, n), dtype=dtype)
    for i in range(n):
        for j in range(i, n):
            mtx[i, j] = mtx[j, i] = jaccard(sketches[i], sketches[j], size)

    def frac(block):
        return np.mean(2 * block / (1 + block))

    return 1 - frac(mtx[:n_tar, :n_tar]), frac(mtx[n_tar:, :n_tar])
