"""Minimizers of one record in plain torch: ntHash v2 and the btllib rule.

The hash (btllib ntHash v2): ``srol`` rotates the low 33 and the high 31
bits of a 64-bit word apart;
``fwd(p) = XOR_j srol^(k-1-j)(SEED[c[p+j]])``,
``rev(p) = XOR_j srol^j(SEED[3 - c[p+j]])``, ``canon = fwd + rev mod 2^64``;
a node's id is ``t ^ (t >> 27)`` with ``t = canon * (1 ^ k * MULTISEED)``.

The selection (btllib's minimizer loop):
1. a k-mer position counts only if its k bases are all valid;
2. over each window of ``w`` consecutive counted positions the candidate is
   the rightmost one holding the least canonical hash (unsigned);
3. a candidate is emitted when its position passes every earlier emitted
   one, and its hash is not 2^64 - 1.

Hashes are int64 tensors that hold the unsigned bit pattern: add, multiply
and XOR wrap as unsigned arithmetic does, and unsigned order is signed
order after the sign bit is flipped.
"""
from __future__ import annotations

import numpy as np
import torch

SEEDS = (0x3C8BFBB395C60474, 0x3193C18562A02B4C, 0x20323ED082572324, 0x295549F54BE24456)
MULTISEED = 0x90B45D39FB6DA1FA
M64 = (1 << 64) - 1
SIGN = -(1 << 63)
WINDOW_ROWS = 1 << 20  # windows per argmin block


def _signed(x: int) -> int:
    x &= M64
    return x - (1 << 64) if x >> 63 else x


def srol(x: int, d: int) -> int:
    lo, hi = x & ((1 << 33) - 1), x >> 33
    d33, d31 = d % 33, d % 31
    lo = ((lo << d33) | (lo >> (33 - d33))) & ((1 << 33) - 1)
    hi = ((hi << d31) | (hi >> (31 - d31))) & ((1 << 31) - 1)
    return (hi << 33) | lo


def seed_tables(k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """int64[k, 5]: the rotated forward and reverse-complement seeds of each
    offset; column 4 (an invalid base) is 0 and never read by a counted
    k-mer."""
    fwd = np.zeros((k, 5), dtype=np.int64)
    rev = np.zeros((k, 5), dtype=np.int64)
    for j in range(k):
        for c in range(4):
            fwd[j, c] = _signed(srol(SEEDS[c], k - 1 - j))
            rev[j, c] = _signed(srol(SEEDS[3 - c], j))
    return torch.from_numpy(fwd).to(device), torch.from_numpy(rev).to(device)


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    return (x >> s) & ((1 << (64 - s)) - 1)


def canonical(codes: torch.Tensor, k: int, tables) -> tuple[torch.Tensor, torch.Tensor]:
    """(canonical hash int64[M], position int64[M]) of every k-mer of one
    record whose k bases are valid (codes uint8, 255 invalid)."""
    dev = codes.device
    n_k = codes.numel() - k + 1
    if n_k <= 0:
        return (torch.zeros(0, dtype=torch.int64, device=dev),) * 2
    bad = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                     torch.cumsum((codes > 3).long(), 0)])
    pos = torch.nonzero(bad[k:] == bad[:-k]).flatten()
    c = codes.long().clamp_(max=4)
    fwd_tab, rev_tab = tables
    fwd = torch.zeros(n_k, dtype=torch.int64, device=dev)
    rev = torch.zeros(n_k, dtype=torch.int64, device=dev)
    for j in range(k):
        cj = c[j:j + n_k]
        fwd ^= fwd_tab[j][cj]
        rev ^= rev_tab[j][cj]
    return (fwd + rev)[pos], pos


def record_minimizers(codes: torch.Tensor, k: int, w: int, tables) -> tuple[torch.Tensor, torch.Tensor]:
    """(node id int64[E], position int64[E]) emitted by one record, whose
    base codes (uint8, 255 invalid) are on the reference's device."""
    dev = codes.device
    canon, pos = canonical(codes, k, tables)
    if pos.numel() < w:
        return (torch.zeros(0, dtype=torch.int64, device=dev),) * 2

    # rightmost least key per window: the first least key of the reversed
    # windows (torch.argmin returns the first of equal minima)
    key_rev = (canon ^ SIGN).flip(0)
    n_win = pos.numel() - w + 1
    first = torch.empty(n_win, dtype=torch.int64, device=dev)
    for b in range(0, n_win, WINDOW_ROWS):
        rows = min(WINDOW_ROWS, n_win - b)
        first[b:b + rows] = key_rev[b:b + rows + w - 1].unfold(0, w, 1).argmin(1)
    sel = torch.arange(n_win, device=dev) + (w - 1) - first.flip(0)

    at = pos[sel]
    emit = torch.ones(n_win, dtype=torch.bool, device=dev)
    emit[1:] = at[1:] > at[:-1]
    emit &= canon[sel] != -1
    chosen = sel[emit]
    t = canon[chosen] * _signed(1 ^ (k * MULTISEED))
    return t ^ _shr(t, 27), pos[chosen]
