"""Unsigned 64-bit arithmetic on ``int64`` tensors.

New in the port (no counterpart module). torch has no shift, compare,
``cummax``, ``searchsorted`` or sort for ``uint64`` on the CPU, so every
64-bit hash in the port is an ``int64`` tensor holding the same bit pattern:

- add, multiply and XOR wrap exactly as unsigned arithmetic does;
- a logical shift right is an arithmetic shift followed by a mask;
- unsigned order is signed order after flipping the sign bit (`key`).
"""
from __future__ import annotations

import numpy as np
import torch

SIGN = -(1 << 63)  # int64 bit pattern of 1 << 63


def as_signed(x: int) -> int:
    """Python int in [0, 2^64) -> the int64 value with the same bits."""
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >> 63 else x


def from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    """uint64 numpy array -> int64 tensor with the same bits."""
    a = np.ascontiguousarray(a, dtype=np.uint64).view(np.int64)
    return torch.from_numpy(a).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> uint64 numpy array with the same bits."""
    return t.detach().cpu().numpy().view(np.uint64)


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical shift right by a constant 0 <= s < 64."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def key(x: torch.Tensor) -> torch.Tensor:
    """Sort/compare key: signed order of ``key(x)`` is unsigned order of x."""
    return x ^ SIGN


def lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return key(a) < key(b)


def le(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return key(a) <= key(b)


def umin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(le(a, b), a, b)


def umax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(le(a, b), b, a)
