"""Sort engine: data-parallel ntHash + minimizer selection in plain torch
(``SEQWIN_TPU_TORCH_SCAN=sort``).

Counterpart: `seqwin_tpu/engine/minimizer.py` (`scan_core`,
`scan_records_host`, `_scan_with_empty_records`). Every k-mer hash is
computed independently via the closed form

    fwd(p) = srol^{k-1+p mod 1023}( XOR_{j=p..p+k-1} srol^{-j mod 1023}(SEED[s_j]) )
    rev(p) = srol^{-p mod 1023}   ( XOR_{j=p..p+k-1} srol^{+j mod 1023}(COMP[s_j]) )

with the per-position rotations reduced mod 33 / mod 31 independently; the
windowed XOR of width k is an O(log k) disjoint-decomposition ladder, the
w-wide rightmost argmin the two-block prefix/suffix scan over the valid
k-mers, and emission one prefix max. Hashes are int64 bit patterns
(`ops/u64.py`): unsigned compares go through the sign-flipped key and
logical shifts through `u64.shr`, as CPU torch has neither for uint64.

All records of a chunk form one flat stream; record boundaries are enforced
through a per-base record ordinal. The emission prefix max needs no
per-record reset: compacted k-mer indices grow across records. Unlike the
hybrid scan, nothing is patched on the host and records are never split.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops import u64
from ..ops.hashing import SEEDS, SEEDS_COMP
from .hybrid import _asm_table, _emission_mask, out_hash
from .phase1 import SENTINEL, _combine_rmin, _shift_left, _shift_right, _srol_parts, _window_any, _window_xor


def _seed_table(seeds, device) -> torch.Tensor:
    """int64[256]: the seed of each base code 0..3, 0 (SEED_N) for the rest."""
    tab = torch.zeros(256, dtype=torch.int64)
    tab[:4] = torch.tensor([u64.as_signed(s) for s in seeds])
    return tab.to(device)


def canon_hashes(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical ntHash (int64 bit patterns) of the k-mer starting at each
    position of a uint8 code stream, by the common-frame closed form; the
    caller masks k-mers that hold a non-ACGT base or leave the stream."""
    iota = torch.arange(codes.numel(), dtype=torch.int64, device=codes.device)
    c = codes.long()
    im33, im31 = iota % 33, iota % 31
    neg33, neg31 = (33 - im33) % 33, (31 - im31) % 31
    a = _srol_parts(_seed_table(SEEDS, codes.device)[c], neg33, neg31)
    b = _srol_parts(_seed_table(SEEDS_COMP, codes.device)[c], im33, im31)
    fwd = _srol_parts(_window_xor(a, k), (im33 + k - 1) % 33, (im31 + k - 1) % 31)
    rev = _srol_parts(_window_xor(b, k), neg33, neg31)
    return fwd + rev


def _window_rmin(mh: torch.Tensor, w: int):
    """(min, index) of the rightmost minimum of every window of ``w``
    consecutive entries ending at each index: per-block prefix and suffix
    scans over blocks of w, the window ending at i being the suffix of the
    block holding i-w+1 and the prefix of the block holding i. Entries
    before the stream read as (SENTINEL, -1)."""
    m = mh.numel()
    dev = mh.device
    pad = (-m) % w
    pm = torch.cat([mh, torch.full((pad,), SENTINEL, dtype=torch.int64, device=dev)])
    pi = torch.cat([torch.arange(m, device=dev), torch.full((pad,), -1, device=dev)])
    rows = (m + pad) // w
    pm, pi = pm.view(rows, w), pi.view(rows, w)
    sm, si = pm, pi
    s = 1
    while s < w:
        fill_m = torch.full((rows, s), SENTINEL, dtype=torch.int64, device=dev)
        fill_i = torch.full((rows, s), -1, dtype=torch.int64, device=dev)
        # prefix: combine(left-shifted-in, self); suffix: combine(self, right)
        pm, pi = _combine_rmin(torch.cat([fill_m, pm[:, :-s]], 1),
                               torch.cat([fill_i, pi[:, :-s]], 1), pm, pi)
        sm, si = _combine_rmin(sm, si, torch.cat([sm[:, s:], fill_m], 1),
                               torch.cat([si[:, s:], fill_i], 1))
        s <<= 1
    p_mh, p_idx = pm.reshape(-1)[:m], pi.reshape(-1)[:m]
    t_mh = _shift_right(sm.reshape(-1), w - 1, SENTINEL)[:m]
    t_idx = _shift_right(si.reshape(-1), w - 1, -1)[:m]
    full_block = torch.arange(m, device=dev) % w == w - 1
    c_mh, c_idx = _combine_rmin(t_mh, t_idx, p_mh, p_idx)
    return torch.where(full_block, p_mh, c_mh), torch.where(full_block, p_idx, c_idx)


def scan_core(codes: torch.Tensor, is_start: torch.Tensor, k: int, w: int):
    """Emitted minimizers of a flat stream of concatenated records.

    Args:
        codes: uint8[N] base codes (0..3 bases, anything else invalid).
        is_start: bool[N], True at the first base of every record; the first
            element must be True.
        k, w: k-mer length and minimizer window.

    Returns:
        (out_hash int64 bit patterns, pos-within-record int64,
        record ordinal int64), exact length, in scan order.
    """
    n = codes.numel()
    dev = codes.device
    iota = torch.arange(n, dtype=torch.int64, device=dev)

    # --- per-base record ordinal and in-record position ---
    rec = torch.cumsum(is_start.long(), 0) - 1
    rec_start = torch.cummax(torch.where(is_start, iota, 0), 0).values
    base_pos = iota - rec_start
    canon = canon_hashes(codes, k)

    # --- k-mer validity (N handling + record containment) ---
    bad_win = _window_any(codes > 3, k)
    rec_end = _shift_left(rec, k - 1, -1)
    valid = ~bad_win & (rec == rec_end) & (iota <= n - k) & (rec >= 0)

    # --- compaction of the valid k-mers (order kept) ---
    mh_c = canon[valid]
    pos_c, rec_c = base_pos[valid], rec[valid]

    # --- w-window rightmost argmin over the valid k-mers ---
    win_mh, win_idx = _window_rmin(mh_c, w)
    # window validity: w valid k-mers, all in one record
    rec_left = _shift_right(rec_c, w - 1, -2)
    win_ok = (torch.arange(mh_c.numel(), device=dev) >= w - 1) & (rec_left == rec_c)

    # --- emission: the candidate index exceeds the running max ---
    z = torch.where(win_ok & (win_mh != SENTINEL), win_idx, -1)
    eidx = z[_emission_mask(z)]
    return out_hash(mh_c[eidx], k), pos_c[eidx], rec_c[eidx]


def _flat_stream(record_codes: list[np.ndarray]):
    """Concatenated codes and record-start flags of non-empty records."""
    codes = np.concatenate(record_codes)
    is_start = np.zeros(len(codes), dtype=bool)
    is_start[np.cumsum([0] + [len(c) for c in record_codes[:-1]])] = True
    return codes, is_start


def scan_records_device(record_codes: list[np.ndarray], k: int, w: int, device=None):
    """`scan_core` over whole records on ``device`` (default: the GPU).
    Returns device tensors (out_hash, pos, rec) with ``rec`` the index into
    ``record_codes``; zero-length records keep their ordinals."""
    dev = resolve_device(device)
    nonempty = [i for i, c in enumerate(record_codes) if len(c)]
    if not nonempty:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return empty, empty, empty
    codes, is_start = _flat_stream([record_codes[i] for i in nonempty])
    oh, pos, rec = scan_core(torch.from_numpy(codes).to(dev),
                             torch.from_numpy(is_start).to(dev), k, w)
    if len(nonempty) < len(record_codes):
        rec = torch.tensor(nonempty, dtype=torch.int64, device=dev)[rec]
    return oh, pos, rec


def scan_records_host(record_codes: list[np.ndarray], k: int, w: int, device=None):
    """`scan_records_device`, copied back: numpy (out_hash u64, pos u32,
    rec i32) in scan order."""
    oh, pos, rec = scan_records_device(record_codes, k, w, device)
    return (u64.to_numpy(oh), pos.cpu().numpy().astype(np.uint32),
            rec.cpu().numpy().astype(np.int32))


def scan_chunk_sort(record_codes: list[np.ndarray], k: int, w: int, rec_base: int = 0,
                    record_offsets=None, device=None):
    """One chunk on the sort engine, in `hybrid.scan_chunk_device`'s
    contract: (e_oh, e_pos, e_rec, count, e_asm) exact-length device
    streams, record ids global via ``rec_base``, or (None, None, None, 0,
    None) for a chunk without bases."""
    dev = resolve_device(device)
    if sum(len(c) for c in record_codes) == 0:
        return None, None, None, 0, None
    oh, pos, rec = scan_records_device(record_codes, k, w, dev)
    asm_tab = torch.from_numpy(_asm_table(record_offsets, rec_base, len(record_codes),
                                          len(record_codes))).to(dev)
    return oh, pos, rec + rec_base, oh.numel(), asm_tab.long()[rec]
