"""Spaced-seed ntHash (btllib `SeedNtHash` semantics).

Counterpart: `seqwin_tpu/ops/spaced.py` (copied: `parse_seed`, `_extend`,
`spaced_oracle`, `_rot_tables`, `spaced_hashes_host`; in torch ops:
`_srol_by`, `spaced_hashes_device`). `Config` validates ``seed_pattern``
with `parse_seed`; the device MinHash sketches (`mash.py`) hash spaced
seeds with `spaced_canon`.

Semantics (``ntmsm64``):

    fwd(i) = XOR_{j : seed[j]=='1'} srol^{k-1-j}(SEED[s_{i+j}])
    rev(i) = XOR_{j : seed[j]=='1'} srol^{j}(SEED_COMP[s_{i+j}])
    h0     = fwd + rev (mod 2^64)                       # canonical
    h_e    = t ^ (t >> 27),  t = h0 * (e ^ k*MULTISEED) # extended, e >= 1
    valid(i) <=> every CARE position of the window is an ACGT base

The device form is a closed form: with c_p = srol^{-p mod 1023}(SEED[s_p])
and X the prefix XOR of c_p,

    fwd(i) = srol^{(k-1+i) mod 1023}( XOR_{[a,b) in care blocks} X[i+b]^X[i+a] )

so any pattern costs one prefix-XOR scan and O(#blocks) vector ops per
position. Hashes on the device are int64 bit patterns (`ops/u64.py`).
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from ..engine.minimizer import _seed_table
from ..engine.phase1 import _srol_parts
from . import u64
from .hashing import M64, MULTISEED, MULTISHIFT, SEEDS, SEEDS_COMP, srol

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


def _extend(h0: np.ndarray, k: int, n_hashes: int) -> np.ndarray:
    """[Q, n_hashes] extended hash values (e=0 is the canonical hash)."""
    out = np.empty((len(h0), n_hashes), dtype=np.uint64)
    out[:, 0] = h0
    with np.errstate(over='ignore'):
        for e in range(1, n_hashes):
            t = h0 * np.uint64((e ^ (k * MULTISEED)) & M64)
            out[:, e] = t ^ (t >> np.uint64(MULTISHIFT))
    return out


def spaced_oracle(codes: np.ndarray, pattern: str, n_hashes: int = 1):
    """Per-position reference implementation (slow, obviously correct).

    Returns (hashes u64[n_valid, n_hashes], positions int64[n_valid]).
    """
    mask, _ = parse_seed(pattern)
    k = len(pattern)
    n = len(codes)
    care = np.flatnonzero(mask)
    positions, h0s = [], []
    for p in range(max(0, n - k + 1)):
        window = codes[p:p + k]
        cs = window[care]
        if np.any(cs > 3):
            continue
        fwd = rev = 0
        for j in care:
            c = int(window[j])
            fwd ^= srol(SEEDS[c], k - 1 - int(j))
            rev ^= srol(SEEDS_COMP[c], int(j))
        h0s.append((fwd + rev) & M64)
        positions.append(p)
    h0 = np.array(h0s, dtype=np.uint64)
    return _extend(h0, k, n_hashes), np.array(positions, dtype=np.int64)


_table_cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}


def _rot_tables(k: int) -> tuple[np.ndarray, np.ndarray]:
    cached = _table_cache.get(k)
    if cached is None:
        fwd = np.zeros((k, 5), dtype=np.uint64)
        rev = np.zeros((k, 5), dtype=np.uint64)
        for j in range(k):
            for c in range(4):
                fwd[j, c] = srol(SEEDS[c], (k - 1 - j) % 1023)
                rev[j, c] = srol(SEEDS_COMP[c], j % 1023)
        cached = _table_cache[k] = (fwd, rev)
    return cached


def spaced_hashes_host(codes: np.ndarray, pattern: str, n_hashes: int = 1):
    """Vectorized NumPy spaced-seed hashing (rotated-table folds over the
    care positions only). Same returns as `spaced_oracle`."""
    mask, _ = parse_seed(pattern)
    k = len(pattern)
    n = len(codes)
    if n < k:
        return np.zeros((0, n_hashes), np.uint64), np.zeros(0, np.int64)
    care = np.flatnonzero(mask).astype(np.int64)
    starts = np.arange(n - k + 1, dtype=np.int64)
    win = codes[starts[:, None] + care[None, :]]
    valid = ~np.any(win > 3, axis=1)
    pos = starts[valid]
    c = np.minimum(win[valid].astype(np.int64), 4)
    fwd_tab, rev_tab = _rot_tables(k)
    fwd = np.bitwise_xor.reduce(fwd_tab[care[None, :], c], axis=1)
    rev = np.bitwise_xor.reduce(rev_tab[care[None, :], c], axis=1)
    with np.errstate(over='ignore'):
        h0 = fwd + rev
    return _extend(h0, k, n_hashes), pos


def _srol_by(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Split rotation srol^d of int64 bit patterns by per-element amounts
    d >= 0: independent left-rotations of the low 33 and high 31 bits."""
    return _srol_parts(x, d % 33, d % 31)


def _prefix_xor(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix XOR, by log-step shift-and-XOR (torch has no XOR
    scan)."""
    s = 1
    while s < x.numel():
        x = torch.cat([x[:s], x[s:] ^ x[:-s]])
        s <<= 1
    return x


def spaced_canon(codes: torch.Tensor, pattern: str):
    """(canonical spaced-seed hash int64[n_win], valid bool[n_win]) of every
    window start of a uint8 code stream (0..3 bases, anything else
    invalid), n_win = max(0, n - k + 1)."""
    _, blocks = parse_seed(pattern)
    k = len(pattern)
    n = codes.numel()
    dev = codes.device
    n_win = max(0, n - k + 1)
    if n_win == 0:
        return (torch.zeros(0, dtype=torch.int64, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
    # per-position pre-rotated seed terms: c_p = srol^{-p mod 1023}(SEED[s_p])
    p = torch.arange(n, device=dev)
    c = codes.long()
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    xf = torch.cat([zero, _prefix_xor(_srol_by(_seed_table(SEEDS, dev)[c], (-p) % 1023))])
    xr = torch.cat([zero, _prefix_xor(_srol_by(_seed_table(SEEDS_COMP, dev)[c], p % 1023))])
    inv = torch.cat([zero, torch.cumsum((codes > 3).long(), 0)])

    i = torch.arange(n_win, device=dev)
    hf = torch.zeros(n_win, dtype=torch.int64, device=dev)
    hr = torch.zeros_like(hf)
    bad = torch.zeros_like(hf)
    for a, b in blocks:
        hf = hf ^ xf[i + b] ^ xf[i + a]
        hr = hr ^ xr[i + b] ^ xr[i + a]
        bad = bad + inv[i + b] - inv[i + a]
    # alignment: fwd terms are srol^{(k-1+i)-p}, rev terms srol^{p-i}
    canon = _srol_by(hf, (i + (k - 1)) % 1023) + _srol_by(hr, (-i) % 1023)
    return canon, bad == 0


def spaced_hashes_device(codes: torch.Tensor, pattern: str, n_hashes: int = 1):
    """Spaced-seed hashing of a uint8 code stream on its device.

    Returns (h int64[count, n_hashes] bit patterns, pos int64[count], count):
    the hashes of all valid windows in position order, as `spaced_oracle`
    gives them.
    """
    k = len(pattern)
    canon, valid = spaced_canon(codes, pattern)
    pos = torch.nonzero(valid).flatten()
    h0 = canon[pos]
    out = [h0]
    for e in range(1, n_hashes):
        t = h0 * u64.as_signed((e ^ (k * MULTISEED)) & M64)
        out.append(t ^ u64.shr(t, MULTISHIFT))
    return torch.stack(out, 1), pos, pos.numel()
