"""Spaced-seed patterns.

Counterpart: `seqwin_tpu/ops/spaced.py::parse_seed` (a copy of the host
validator only; the spaced-seed hashing belongs to the device sketches,
ROADMAP A12). `Config` validates ``seed_pattern`` with it.
"""
from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)


def parse_seed(pattern: str) -> tuple[np.ndarray, list[tuple[int, int]]]:
    """Validate a '1'/'0' spaced-seed pattern -> (care mask bool[k], care
    blocks [(start, stop), ...]). Warns (like the reference) when the pattern
    is not palindromic, since reverse-complement hashing is then inconsistent.
    """
    if not pattern or any(c not in '01' for c in pattern):
        raise ValueError(f'spaced seed must be a non-empty 1/0 string: {pattern!r}')
    if pattern[0] != '1' or pattern[-1] != '1':
        raise ValueError(f'spaced seed must start and end with 1: {pattern!r}')
    if pattern != pattern[::-1]:
        logger.warning(
            f'spaced seed {pattern} is not symmetric; '
            'reverse-complement hashing will be inconsistent')
    mask = np.frombuffer(pattern.encode(), dtype=np.uint8) == ord('1')
    blocks: list[tuple[int, int]] = []
    j = 0
    k = len(pattern)
    while j < k:
        if mask[j]:
            b = j
            while b < k and mask[b]:
                b += 1
            blocks.append((j, b))
            j = b
        else:
            j += 1
    return mask, blocks
