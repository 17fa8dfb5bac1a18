"""Compaction-free minimizer scan of one chunk: clean windows on the device,
irregular windows patched by the host.

Counterpart: `seqwin_tpu/engine/hybrid.py`. The host prep is copied as-is
(`_host_layout`, `_merge_intervals`, `_SparseValidity`,
`_irregular_positions`, `host_patches`, `_asm_table`); `_record_block_plan`
gives the same plan from sparse ranks; the device side (`_emission`,
`_canon_at_emitted`, `scan_chunk_device`, `_block_adjust`,
`scan_record_blocks`, `scan_records_hybrid`) is ported to torch. A record
longer than the chunk budget is scanned in halo'd blocks, one kernel B1
launch each (`scan_blocks`).

- A window ending at valid k-mer position ``p`` whose last ``w`` positions are
  all valid k-mers of one record is clean: its argmin runs directly in
  position space (`phase1.phase1_z`).
- Windows whose span holds an invalid k-mer position (N runs, record
  junctions, record heads) are irregular. The host enumerates them from the
  base codes and record layout, resolves each exact rightmost argmin, and the
  device writes those patches over z.
- Emission is one running max over z: emit where z >= 0 and z exceeds every
  earlier z. Positions grow monotonically, so emitted values come out in
  ascending position order.

The port sizes each chunk's stream to the chunk itself and ships the
augmented byte stream (bit 6 = record start) as it is.

Three extractions, chosen by path. The single-device build's chunks take
the deferred one (`scan_chunk_deferred`, the JAX ``defer_sync=True``): the
host half (`pinned_host_prep`) runs in a thread pool, and the dispatch half
copies from page-locked memory without blocking, launches B1, patches, and
fills ``emit_capacity`` slots with the emitted positions (a cumulative sum
and a binary search per slot), returning the count as a device scalar; the
caller fetches every chunk's count at once and re-runs a chunk that
overflowed with the exact, synchronous `scan_chunk_device` (the mask
extraction, which long-record blocks also take). The multi-device build,
which knows every shard's exact counts from its pre-pass, takes the pfx
extraction (`scan_phase2_pfx` over kernel B3's tile staircases,
counterpart of the JAX `scan_phase2_pfx`), which needs no host sync to
size its outputs.

Spans (`engine/timeline.py`): ``hybrid.host_prep`` around every chunk's
host prep, in whichever thread runs it (``parent`` names the span that
handed it over); inside it ``hybrid.patches`` around `host_patches`, with
the chunk's ``records`` (record starts), ``windows`` (irregular windows
patched) and ``ranks`` (positions hashed for them); and ``block.sync``
around each host read of the block path: `scan_chunk_device`'s boolean
index of the emission and `_block_adjust`'s `tolist()`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops import u64
from ..ops.hashing import MULTISHIFT, out_hash_mult
from . import timeline
from .phase1 import _shift_right, pfx_from_z, phase1_z, rot_seed_tables  # noqa: F401


def _host_layout(record_codes: list[np.ndarray], n: int, offset: int = 0,
                 out: np.ndarray | None = None):
    """Concatenate records at ``offset``; per-base codes + record-start
    offsets. ``out`` (uint8[n]) receives the codes instead of a new array."""
    codes = np.full(n, 255, dtype=np.uint8) if out is None else out
    if out is not None:
        codes.fill(255)
    starts = np.zeros(len(record_codes), dtype=np.int64)
    off = offset
    for ri, c in enumerate(record_codes):
        L = len(c)
        codes[off:off + L] = c
        starts[ri] = off
        off += L
    return codes, starts


def _merge_intervals(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Merge overlapping/adjacent inclusive intervals."""
    if len(a) == 0:
        return a, b
    order = np.argsort(a, kind='stable')
    a, b = a[order], b[order]
    b_run = np.maximum.accumulate(b)
    new = np.ones(len(a), dtype=bool)
    new[1:] = a[1:] > b_run[:-1] + 1
    starts_i = np.flatnonzero(new)
    ends_i = np.append(starts_i[1:], len(a)) - 1
    return a[starts_i], b_run[ends_i]


class _SparseValidity:
    """Interval view of the invalid-k-mer set of one chunk.

    Built in O(#invalid-bases + #records); answers validity, rank, and
    rank->position queries with binary searches over merged intervals.
    The k-mer domain is [0, total - k].
    """

    def __init__(self, codes: np.ndarray, starts: np.ndarray, k: int, total: int,
                 inv_points: np.ndarray | None = None):
        self.k = k
        self.total = total
        self.last = total - k  # inclusive k-mer domain end (may be < 0)
        if inv_points is not None:
            inv = np.asarray(inv_points, dtype=np.int64)
            inv = inv[inv < total]
        else:
            # strip the record-start flag (bit 6) before the validity test
            inv = np.flatnonzero((codes[:total] & 63) > 3).astype(np.int64)
        a_parts = [np.maximum(inv - k + 1, 0)]
        b_parts = [np.minimum(inv, max(self.last, 0))]
        if k > 1 and len(starts) > 1:
            s = np.asarray(starts[1:], dtype=np.int64)
            a_parts.append(np.maximum(s - k + 1, 0))
            b_parts.append(np.minimum(s - 1, max(self.last, 0)))
        a = np.concatenate(a_parts)
        b = np.concatenate(b_parts)
        keep = a <= b
        self.A, self.B = _merge_intervals(a[keep], b[keep])
        lens = self.B - self.A + 1
        self.cumlen = np.concatenate(([0], np.cumsum(lens)))

    def invalid_leq(self, x) -> np.ndarray:
        """#invalid k-mer positions <= x (vectorized)."""
        x = np.minimum(np.asarray(x, dtype=np.int64), self.last)
        if len(self.A) == 0:
            return np.zeros_like(x)
        j = np.searchsorted(self.A, x, side='right') - 1
        jc = np.maximum(j, 0)
        partial = np.clip(np.minimum(x, self.B[jc]) - self.A[jc] + 1, 0, None)
        out = np.where(j >= 0, self.cumlen[jc] + partial, 0)
        return np.where(x < 0, 0, out)

    def is_valid(self, pos: np.ndarray) -> np.ndarray:
        pos = np.asarray(pos, dtype=np.int64)
        ok = (pos >= 0) & (pos <= self.last)
        if len(self.A) == 0:
            return ok
        j = np.searchsorted(self.A, pos, side='right') - 1
        jc = np.maximum(j, 0)
        in_iv = (j >= 0) & (pos <= self.B[jc])
        return ok & ~in_iv

    def rank(self, pos) -> np.ndarray:
        """Global valid rank (0-based) of a valid k-mer position."""
        pos = np.asarray(pos, dtype=np.int64)
        return pos - self.invalid_leq(pos)

    def pos_of_rank(self, q) -> np.ndarray:
        """Position of the q-th (0-based) valid k-mer."""
        q = np.asarray(q, dtype=np.int64)
        if len(self.A) == 0:
            return q
        # gap g starts at B[g-1]+1 (gap 0 starts at 0); valid count before it
        gap_start = np.concatenate(([0], self.B + 1))
        valid_before = gap_start - np.concatenate(([0], self.cumlen[1:]))
        g = np.searchsorted(valid_before, q, side='right') - 1
        return gap_start[g] + (q - valid_before[g])


def _irregular_positions(sv: '_SparseValidity', starts: np.ndarray, w: int):
    """Positions of irregular window ends, sparsely.

    A window ending at valid k-mer ``p`` (with >= w valid k-mers so far in its
    record) is irregular iff a *blocker* -- an invalid k-mer position or a
    record start -- lies in [p-w+1, p]. Candidates are enumerated per merged
    blocker interval, so the cost is O(#blockers * w), independent of N.
    The blocker definition mirrors phase 1's clean mask exactly.

    Returns sorted int64[Q].
    """
    starts64 = np.asarray(starts, dtype=np.int64)

    # blocker intervals = invalid k-mer intervals + [s, s] per record start
    blk_a = np.concatenate([sv.A, starts64])
    blk_b = np.concatenate([sv.B, np.minimum(starts64, sv.last)])
    keep = blk_a <= blk_b
    blk_a, blk_b = _merge_intervals(blk_a[keep], blk_b[keep])

    cand_list = [
        np.arange(a, min(b + w - 1, sv.last) + 1, dtype=np.int64)
        for a, b in zip(blk_a, blk_b)
    ]
    if not cand_list:
        return np.zeros(0, np.int64)
    cand = np.unique(np.concatenate(cand_list))
    cand = cand[sv.is_valid(cand)]
    if len(cand) == 0:
        return np.zeros(0, np.int64)

    # rank within record = global rank - valid count before the record start
    c_rec = np.searchsorted(starts64, cand, side='right') - 1
    rec_start = starts64[c_rec]
    vb = rec_start - sv.invalid_leq(rec_start - 1)
    rank_in_rec = sv.rank(cand) - vb
    return cand[rank_in_rec >= w - 1]


_SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)


def host_patches(starts: np.ndarray, k: int, w: int, n: int,
                 total: int | None = None,
                 inv_points: np.ndarray | None = None,
                 codes: np.ndarray | None = None,
                 packed: np.ndarray | None = None, span=None):
    """Irregular windows and their exact rightmost-argmin patches, on host.

    Phase 1 assumes every window of w consecutive positions is w consecutive
    VALID k-mers of ONE record; windows near blockers (invalid bases, record
    starts) violate that and are patched here. The argmin runs as a
    sliding-window rightmost-min in valid-rank space: candidate windows are
    grouped into contiguous rank ranges, each needed rank is hashed once, and
    a two-block (per-block prefix/suffix rightmost argmin) pass answers every
    window -- O(Q + w * #groups) hashed positions.

    Exactly one of ``codes`` (augmented byte stream) / ``packed`` (2-bit
    stream, requires ``inv_points``) supplies the hash input. ``span``, an
    open `timeline.span`, receives the ``windows`` patched and the
    ``ranks`` hashed.

    Returns (irr_pos int32[Q], patch_z int32[Q]); ``patch_z`` is the stream
    position of each window's rightmost minimal member (-1 = no minimum).
    """
    if total is None:
        total = n
    sv = _SparseValidity(codes, starts, k, total, inv_points=inv_points)
    empty = (np.zeros(0, np.int32), np.zeros(0, np.int32))
    if sv.last < 0:
        return empty
    irr_pos = _irregular_positions(sv, starts, w)
    Q = len(irr_pos)
    if Q == 0:
        return empty

    # group windows into contiguous rank ranges: window ends at rank r cover
    # [r-w+1, r]; consecutive ends <= w ranks apart share one range
    ranks = sv.rank(irr_pos)
    brk = np.empty(Q, bool)
    brk[0] = True
    brk[1:] = np.diff(ranks) > w
    gid = np.cumsum(brk) - 1
    first = np.flatnonzero(brk)
    last_i = np.append(first[1:], Q) - 1
    lo = ranks[first] - (w - 1)          # >= 0: rank_in_rec >= w-1
    hi = ranks[last_i]
    lens = hi - lo + 1
    flat_off = np.concatenate(([0], np.cumsum(lens)))
    r_tot = int(flat_off[-1])
    if span:
        span.set(windows=Q, ranks=r_tot)

    # hash every needed rank once
    all_ranks = np.arange(r_tot, dtype=np.int64) + np.repeat(lo - flat_off[:-1], lens)
    pos = sv.pos_of_rank(all_ranks)
    if packed is not None:
        from ..ops.host_hash import canon_at_packed

        h = canon_at_packed(packed, pos, k)
    else:
        from ..ops.host_hash import canon_at

        h = canon_at(codes, pos, k)

    # two-block sliding rightmost-min over the flat rank array (block = w):
    # a window [s, e=s+w-1] is exactly suffix-of-block(s) + prefix-of-block(e),
    # and both parts lie inside [s, e], so blocks spanning group boundaries
    # never leak values into any real window. Sentinel pad never queried.
    nb = -(-r_tot // w)
    hh = np.full(nb * w, _SENTINEL, np.uint64)
    hh[:r_tot] = h
    hh = hh.reshape(nb, w)
    iota = np.arange(w)
    # L: rightmost argmin of block[0..j] -- flag where h equals its running
    # min (ties re-flag: rightmost wins), then last flagged index
    runmin = np.minimum.accumulate(hh, axis=1)
    lidx = np.maximum.accumulate(
        np.where(hh == runmin, iota[None, :], -1), axis=1)
    # R: rightmost argmin of block[j..end] -- in reversed coords the
    # rightmost tie is the LAST strict improvement of the running min
    rev = hh[:, ::-1]
    runminr = np.minimum.accumulate(rev, axis=1)
    rflag = np.empty(rev.shape, bool)
    rflag[:, 0] = True
    rflag[:, 1:] = runminr[:, 1:] < runminr[:, :-1]
    ridx_rev = np.maximum.accumulate(np.where(rflag, iota[None, :], -1), axis=1)

    f_e = flat_off[gid] + (ranks - lo[gid])
    f_s = f_e - (w - 1)
    be, ce = np.divmod(f_e, w)
    bs, cs = np.divmod(f_s, w)
    lmin = runmin[be, ce]
    lflat = be * w + lidx[be, ce]
    crev = w - 1 - cs
    rmin = runminr[bs, crev]
    rflat = bs * w + (w - 1 - ridx_rev[bs, crev])
    use_l = lmin <= rmin  # L part is the right half: ties stay rightmost
    zflat = np.where(use_l, lflat, rflat)
    zmin = np.minimum(lmin, rmin)
    z_rank = zflat - flat_off[gid] + lo[gid]
    z_pos = sv.pos_of_rank(z_rank)
    patch_z = np.where(zmin == _SENTINEL, -1, z_pos).astype(np.int32)
    return irr_pos.astype(np.int32), patch_z


def _asm_table(record_offsets, rec_base: int, n_records: int, cap: int) -> np.ndarray:
    """int32[cap] table: local record index -> assembly index.

    Built from the global cumulative record counts (`record_offsets`) for the
    records [rec_base, rec_base + n_records); padding rows hold the last
    assembly (harmless -- consumers mask dead lanes).
    """
    tab = np.zeros(cap, dtype=np.int32)
    if record_offsets is not None and n_records:
        off_h = np.asarray(record_offsets, dtype=np.int64)
        recs = rec_base + np.arange(n_records, dtype=np.int64)
        tab[:n_records] = np.clip(
            np.searchsorted(off_h, recs, side='right') - 1, 0, len(off_h) - 2
        ).astype(np.int32)
        tab[n_records:] = tab[max(n_records - 1, 0)]
    return tab


_EMIT_ROW = 1 << 13  # row width of the blocked running max


def _cummax_rows(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running max of a 1-D stream, evaluated row-blocked as
    `_emission_rows` does in the JAX package: a per-row cummax plus one
    exclusive cummax over the row maxima. On a CUDA device torch scans each
    row in one block, so a single 2^25-long row takes ~80 ms where rows of
    2^13 take a small fraction."""
    n = x.numel()
    pad = (-n) % _EMIT_ROW
    if pad:  # trailing padding never reaches an earlier running max
        x = torch.cat([x, x.new_zeros(pad)])
    cm = torch.cummax(x.view(-1, _EMIT_ROW), 1).values
    low = torch.full((1,), torch.iinfo(x.dtype).min, dtype=x.dtype, device=x.device)
    carry = torch.cat([low, torch.cummax(cm[:, -1], 0).values[:-1]])
    return torch.maximum(cm, carry[:, None]).view(-1)[:n]


def _emission_mask(z: torch.Tensor) -> torch.Tensor:
    """Emission flags of a (patched) z stream: z >= 0 and z strictly above
    the running max of all earlier z (starting from -2)."""
    before = _shift_right(_cummax_rows(z), 1, -2)
    return (z >= 0) & (z > before)


def _emission(z: torch.Tensor) -> torch.Tensor:
    """Emitted values of a (patched) z stream, in stream order."""
    return z[_emission_mask(z)]


def _canon_at_emitted(codes_aug: torch.Tensor, eidx: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical ntHash (int64 bit patterns) at emitted positions: k gathers
    of the code stream + table folds. Emitted positions are valid k-mers."""
    dev = codes_aug.device
    fwd_t, rev_t = rot_seed_tables(k, dev)
    f = torch.zeros(eidx.shape, dtype=torch.int64, device=dev)
    r = torch.zeros_like(f)
    last = codes_aug.numel() - 1
    for j in range(k):
        # a no-op for emitted positions; keeps padding slots in the stream
        c = (codes_aug[(eidx + j).clamp_(max=last)] & 3).long()
        f ^= fwd_t[j][c]
        r ^= rev_t[j][c]
    return f + r


def out_hash(canon: torch.Tensor, k: int) -> torch.Tensor:
    """The out-hash of canonical hashes (int64 bit patterns both)."""
    t = canon * u64.as_signed(out_hash_mult(k))
    return t ^ u64.shr(t, MULTISHIFT)


def chunk_host_prep(record_codes: list[np.ndarray], k: int, w: int,
                    rec_base: int = 0, record_offsets=None, out: np.ndarray | None = None,
                    parent=None):
    """Host prep of one stream of whole records: the augmented byte stream
    (bit 6 = record start; written into ``out`` when given), record starts,
    the irregular-window patches and the local record -> assembly table.
    Pure numpy: chunks prep in parallel threads (``parent``: the span that
    handed the chunk over)."""
    total = int(sum(len(c) for c in record_codes))
    with timeline.span('hybrid.host_prep', parent=parent, rec_base=rec_base, bases=total):
        codes, starts = _host_layout(record_codes, total, out=out)
        # empty records share their start with the next record (or sit at total)
        codes[starts[starts < total]] |= 64
        with timeline.span('hybrid.patches', records=len(starts), windows=0, ranks=0) as s:
            irr_pos, patch_z = host_patches(starts, k, w, total, codes=codes, span=s)
        asm_tab = _asm_table(record_offsets, rec_base, len(starts), len(starts))
    return codes, starts, irr_pos, patch_z, asm_tab


def _emitted_streams(codes_d, eidx, k: int, starts_d, rec_base: int, asm_tab_d):
    """(e_oh, e_pos, e_rec, e_asm) of the emitted positions ``eidx``."""
    e_oh = out_hash(_canon_at_emitted(codes_d, eidx, k), k)
    # over ALL starts (duplicates included): right-searchsorted picks the
    # last record starting at or before the position -- the non-empty one
    rec_local = (torch.searchsorted(starts_d, eidx, right=True) - 1).clamp_(0, starts_d.numel() - 1)
    e_pos = eidx - starts_d[rec_local]
    return e_oh, e_pos, rec_local + rec_base, asm_tab_d.long()[rec_local]


def emit_capacity(n: int, w: int) -> int:
    """Emission slots of a deferred chunk of ``n`` positions: 2.5 / (w + 1)
    per position, 25% above the expected minimizer density 2 / (w + 1),
    and at least 4096 (the JAX package's formula,
    `seqwin_tpu/engine/hybrid.py:1008`, without its power of two)."""
    return min(max(1 << 12, int(2.5 * n / (w + 1)) + 64), n)


def _emission_capped(z: torch.Tensor, cap: int):
    """The first ``cap`` emitted values of a (patched) z stream (`_emission`)
    and the emitted count, without a host sync: (eidx int64[cap], count 0-d
    int64). Slot j takes z where the running count of emissions first
    reaches j + 1 (a binary search of the cumulative sum); slots past the
    count hold ``z.numel()``, which `_emitted_streams` gathers safely."""
    n = z.numel()
    csum = torch.cumsum(_emission_mask(z), 0, dtype=torch.int32)
    at = torch.searchsorted(csum, torch.arange(1, cap + 1, dtype=torch.int32, device=z.device))
    eidx = torch.where(at < n, z[at.clamp(max=n - 1)].long(), n)
    return eidx, csum[-1].long()


def pinned_host_prep(record_codes: list[np.ndarray], k: int, w: int, rec_base: int,
                     record_offsets, device: torch.device, parent=None):
    """The host half of a deferred chunk scan: `chunk_host_prep` as torch
    tensors, in page-locked memory when ``device`` is a GPU (the source of
    `scan_chunk_deferred`'s copies that do not block). The caller keeps
    them until the chunk's count is fetched."""
    total = int(sum(len(c) for c in record_codes))
    timeline.mark('prep_start', rec_base=rec_base, bases=total)
    pin = device.type == 'cuda'
    buf = torch.empty(total, dtype=torch.uint8, pin_memory=pin)
    _, *rest = chunk_host_prep(record_codes, k, w, rec_base, record_offsets, out=buf.numpy(),
                               parent=parent)
    rest = [torch.from_numpy(a) for a in rest]
    return (buf, *(t.pin_memory() for t in rest)) if pin else (buf, *rest)


def scan_chunk_deferred(prep, k: int, w: int, rec_base: int, device):
    """The dispatch half of a deferred chunk scan (counterpart of the JAX
    ``scan_chunk_device(defer_sync=True)``): enqueue the h2d of the
    `pinned_host_prep` tensors ``prep``, B1, the patches, the emission into
    `emit_capacity` slots and the emitted streams, with no host sync.

    Returns (e_oh, e_pos, e_rec, count, e_asm): streams of emit_capacity
    entries, the first ``count`` of them real (when count <= the capacity),
    and ``count`` the emitted count as a 0-d device tensor. A chunk whose
    count exceeds its capacity is re-run with `scan_chunk_device`."""
    codes_h, starts_h, irr_h, pz_h, asm_h = prep
    dev = torch.device(device)
    timeline.mark('h2d_submit', rec_base=rec_base, bytes=codes_h.numel())
    codes_d, starts_d, irr_d, pz_d, asm_d = (t.to(dev, non_blocking=True) for t in prep)
    timeline.mark('h2d_returned', rec_base=rec_base)
    z = phase1_z(codes_d, k, w)
    if irr_h.numel():
        z[irr_d.long()] = pz_d
    eidx, count = _emission_capped(z, emit_capacity(codes_h.numel(), w))
    e_oh, e_pos, e_rec, e_asm = _emitted_streams(codes_d, eidx, k, starts_d, rec_base, asm_d)
    timeline.mark('dispatched', rec_base=rec_base)
    return e_oh, e_pos, e_rec, count, e_asm


def scan_chunk_device(record_codes: list[np.ndarray], k: int, w: int,
                      rec_base: int = 0, record_offsets=None, device=None):
    """Scan one chunk on ``device``; emitted minimizers stay device-resident.

    Returns (e_oh int64 bit patterns of u64, e_pos int64, e_rec int64,
    count int, e_asm int64), each of exactly ``count`` entries in stream
    order, or (None, None, None, 0, None) for an empty chunk. Record ids are
    global via ``rec_base``; ``e_asm`` is the per-entry assembly index when
    ``record_offsets`` is given (else zeros). Syncs once, on the emission's
    boolean index.
    """
    dev = resolve_device(device)
    total = int(sum(len(c) for c in record_codes))
    if total == 0:
        return None, None, None, 0, None
    timeline.mark('prep_start', rec_base=rec_base, bases=total)
    codes, starts, irr_pos, patch_z, asm_tab = chunk_host_prep(
        record_codes, k, w, rec_base, record_offsets)

    timeline.mark('h2d_submit', rec_base=rec_base, bytes=codes.nbytes)
    codes_d = torch.from_numpy(codes).to(dev)
    timeline.mark('h2d_returned', rec_base=rec_base)
    z = phase1_z(codes_d, k, w)
    if len(irr_pos):
        z[torch.from_numpy(irr_pos).to(dev).long()] = torch.from_numpy(patch_z).to(dev)
    with timeline.span('block.sync'):
        eidx = _emission(z).long()
    e_oh, e_pos, e_rec, e_asm = _emitted_streams(
        codes_d, eidx, k, torch.from_numpy(starts).to(dev), rec_base,
        torch.from_numpy(asm_tab).to(dev))
    return e_oh, e_pos, e_rec, int(eidx.numel()), e_asm


def _record_block_plan(codes: np.ndarray, k: int, w: int, budget: int):
    """Host: split one oversized record into exact scan blocks with halos.

    Each block re-scans a halo of exactly w-1 valid k-mers preceding its
    first new window, so every window the block emits for is fully visible.
    Returns [(slice_start, slice_stop), ...] in record coordinates, or None
    when splitting is degenerate (few valid k-mers). The JAX package's plan;
    the valid k-mer positions are ranked through the merged intervals of the
    invalid ones (`_SparseValidity`) instead of a prefix sum over the whole
    record, which took most of a low-memory build's host time.
    """
    L = len(codes)
    nk = L - k + 1
    if nk <= 0:
        return None
    sv = _SparseValidity(codes, np.zeros(1, np.int64), k, L,
                         inv_points=np.flatnonzero(codes > 3))
    m = nk - int(sv.cumlen[-1])  # valid k-mer positions
    if m < w + 1:
        return None

    def vpos(rank: int) -> int:
        return int(sv.pos_of_rank(rank))

    blocks = []
    e_prev = w - 2  # last window-ending rank already handled
    start = 0
    while e_prev < m - 1:
        # rank of the last valid k-mer at or before start + budget - k
        x = min(start + budget - k, nk - 1)
        e = (x + 1 - int(sv.invalid_leq(x)) if x >= 0 else 0) - 1
        e = min(max(e, e_prev + 1), m - 1)
        blocks.append((start, min(L, vpos(e) + k)))
        start = vpos(min(max(0, e - w + 2), m - 1))  # w-1 valid-kmer halo
        e_prev = e
    return blocks


def _block_adjust(res, b0: int, carry: int):
    """Rebase one block's exact-length emission streams (a
    `scan_chunk_device` result) to record coordinates and drop the halo's
    re-emissions: positions <= carry, always a prefix since emissions
    ascend. Returns the kept (e_oh, e_pos, e_rec, count, e_asm), count 0 when
    the block keeps nothing, and the carry after the block (the last kept
    position so far)."""
    e_oh, e_pos, e_rec, count, e_asm = res
    if not count:
        return res, carry
    gpos = e_pos + b0
    with timeline.span('block.sync'):
        n_drop, last = torch.stack([(gpos <= carry).sum(), gpos[-1]]).tolist()
    return ((e_oh[n_drop:], gpos[n_drop:], e_rec[n_drop:], count - n_drop, e_asm[n_drop:]),
            max(carry, last))


def scan_blocks(codes: np.ndarray, plan, k: int, w: int, rec_idx: int,
                record_offsets, devices) -> list:
    """Scan one record by its block ``plan`` (`_record_block_plan`), block i
    with kernel B1 on ``devices[i]``, in plan order, the carry kept on the
    host. A degenerate plan (None or one block) scans the record whole on
    ``devices[0]``. Returns one `scan_chunk_device` result per launch, each
    on its block's device, ``e_pos`` in record coordinates; concatenated in
    order they are the whole record's emission streams."""
    if plan is None or len(plan) <= 1:
        return [scan_chunk_device([codes], k, w, rec_idx, record_offsets, device=devices[0])]
    out, carry = [], -1
    for (b0, b1), dev in zip(plan, devices):
        kept, carry = _block_adjust(scan_chunk_device(
            [codes[b0:b1]], k, w, rec_idx, record_offsets, device=dev), b0, carry)
        out.append(kept)
    return out


def scan_record_blocks(codes: np.ndarray, k: int, w: int, rec_idx: int, budget: int,
                       record_offsets=None, device=None) -> list:
    """Exact chunked scan of ONE record larger than the chunk budget, on
    ``device``: halo'd blocks of at most ``budget`` bases (`scan_blocks`).

    The rightmost-min window argmin position is monotone non-decreasing as
    the window slides, so the emission state at any cut is one scalar, the
    last emitted position (carry); each block is scanned with a halo of w-1
    preceding valid k-mers, and its candidates at positions <= carry are
    exactly the halo's re-emissions. The junction edges between blocks need
    no bridge: the streams are exact-length, so the last kept emission of
    one block and the first of the next sit side by side in the
    concatenated stream, with the same record index.
    """
    codes = np.asarray(codes)
    plan = _record_block_plan(codes, k, w, budget)
    dev = resolve_device(device)
    return scan_blocks(codes, plan, k, w, rec_idx, record_offsets,
                       [dev] * (len(plan) if plan else 1))


def scan_records_hybrid(record_codes: list[np.ndarray], k: int, w: int,
                        device=None) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host wrapper of one `scan_chunk_device` over ``record_codes`` (records
    0..): (oh uint64, pos uint32, rec int32) numpy arrays of the emitted
    minimizers in scan order, the contract of `minimizer.scan_records_host`.
    Counterpart of `seqwin_tpu/engine/hybrid.py::scan_records_hybrid`,
    without its ``min_chunk`` (the port sizes a stream to its records)."""
    e_oh, e_pos, e_rec, count, _ = scan_chunk_device(record_codes, k, w, 0, device=device)
    if e_oh is None:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint32), np.zeros(0, np.int32)
    return (u64.to_numpy(e_oh), e_pos.cpu().numpy().astype(np.uint32),
            e_rec.cpu().numpy().astype(np.int32))


def _bsearch_rows(flat, row, tgt, ts: int, side_left: bool):
    """First in-row index where flat[row*ts + idx] >= tgt (side_left) or
    > tgt (not side_left); rows gathered point-wise (no [Q, ts] slices)."""
    lo = torch.zeros_like(row)
    hi = torch.full_like(row, ts)
    base = row * ts
    for _ in range(max(1, ts.bit_length())):
        mid = (lo + hi) >> 1
        v = flat[base + mid.clamp(max=ts - 1)]
        go = ((v < tgt) if side_left else (v <= tgt)) & (mid < hi)
        lo = torch.where(go, mid + 1, lo)
        hi = torch.where(go, hi, mid)
    return lo


_FAR = 1 << 62  # past every stream position


def scan_phase2_pfx(zpfx, lrank, codes_aug, patch_pos, patch_z, starts,
                    rec_base: int, asm_tab, emit_cap: int, count: int, k: int):
    """Emission extraction from kernel B3's tile staircases (the pfx route):
    no stream-wide scan, only tile-count, patch-count and emit_cap scale
    gathers, binary searches and scans.

    The window-argmin sequence of one stream is a monotone staircase, so
    emissions are its distinct values. Across tiles the carry is an
    exclusive max over the tile maxima, and the emissions a tile re-climbs
    below the carry are a prefix of its local ones (K_t, one binary search
    per tile). The host patches form their own staircase; each side
    suppresses the other's non-advances and output slots come from rank
    arithmetic over the two monotone lists.

    ``emit_cap`` must cover the clean-only emission count (the suppression
    bookkeeping only tracks the first emit_cap clean emissions), and
    ``count`` (<= emit_cap) is the exact emission count, both from the
    count pre-pass. Returns (e_oh, e_pos, e_rec, dev_count, e_asm): streams
    of exactly ``count`` entries, and the device's own count (a 0-d tensor;
    above emit_cap when the clean count overflows it), which the caller
    holds against ``count``.
    """
    dev = zpfx.device
    T, ts = zpfx.shape
    zp, lr = zpfx.reshape(-1).long(), lrank.reshape(-1).long()
    # one sentinel patch past every emission keeps the patch arrays non-empty
    patch_pos = torch.cat([patch_pos.long(), torch.full((1,), codes_aug.numel(), device=dev)])
    patch_z = torch.cat([patch_z.long(), torch.full((1,), -1, device=dev)])
    pcap = patch_pos.numel()

    # --- cross-tile carry + per-tile double-count correction K_t ---
    tile_max = zp.view(T, ts)[:, -1]
    carry = _shift_right(torch.cummax(tile_max, 0).values, 1, -1)
    rows = torch.arange(T, device=dev)
    q = _bsearch_rows(zp, rows, carry, ts, side_left=False) - 1
    K = torch.where(q >= 0, lr[rows * ts + q.clamp(min=0)], 0)
    surv = lr.view(T, ts)[:, -1] - K
    cum = torch.cumsum(surv, 0)
    count_g = cum[-1]

    # --- the j-th clean emission: tile, in-tile rank target, position ---
    j = torch.arange(emit_cap, device=dev)
    t_c = torch.searchsorted(cum, j, right=True).clamp(max=T - 1)
    tgt = j - (cum[t_c] - surv[t_c]) + K[t_c] + 1
    pos_in = _bsearch_rows(lr, t_c, tgt, ts, side_left=True)
    gv = zp[t_c * ts + pos_in.clamp(max=ts - 1)]  # emitted value (min pos)
    live_g = j < torch.clamp(count_g, max=emit_cap)
    gp = torch.where(live_g, t_c * ts + pos_in, _FAR)

    # --- patch staircase (values of host-patched irregular windows) ---
    pm = torch.cummax(patch_z, 0).values
    qp = patch_pos.clamp(0, T * ts - 1)
    g_at = torch.maximum(zp[qp], carry[qp // ts])  # clean prefix at q
    flag_p = ((pm > _shift_right(pm, 1, -1)) & (pm > g_at)
              & (patch_pos < T * ts) & (patch_z >= 0))
    pfs = torch.cumsum(flag_p.long(), 0)
    count_p = pfs[-1]

    # --- cross-suppression + merge ranks (all monotone-list arithmetic) ---
    jq = torch.searchsorted(patch_pos, gp)
    pmq = torch.where(jq > 0, pm[(jq - 1).clamp(min=0)], -1)
    sup_g = live_g & (pmq >= gv)
    surv_ord = torch.cumsum((live_g & ~sup_g).long(), 0)  # inclusive
    # nsup[i]: suppressed among the first i clean emissions
    nsup = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.cumsum(sup_g.long(), 0)])
    # patch ranks: #surviving G with position < q, + own survivor ordinal
    m_g = torch.searchsorted(gp, patch_pos)
    rank_p = pfs - 1 + m_g - nsup[m_g]
    dev_count = count_g - nsup[-1] + count_p
    # the bookkeeping above only covers the first emit_cap CLEAN emissions:
    # a clean overflow must not let suppressions pull the count back under
    dev_count = torch.where(count_g > emit_cap,
                            torch.clamp(dev_count, min=emit_cap + 1), dev_count)

    # --- resolve the `count` output slots ---
    r = torch.arange(count, device=dev)
    # patch survivors by ordinal: strictly increasing final ranks
    ordp = torch.searchsorted(pfs, torch.arange(pcap, device=dev) + 1).clamp(max=pcap - 1)
    prank_ord = torch.where(torch.arange(pcap, device=dev) < count_p, rank_p[ordp], _FAR)
    pu = torch.searchsorted(prank_ord, r)
    pu_c = pu.clamp(max=pcap - 1)
    is_p = (pu < pcap) & (prank_ord[pu_c] == r)
    # G survivor with ordinal (r - #patch survivors ranked below r)
    gj = torch.searchsorted(surv_ord, r - pu + 1).clamp(max=max(emit_cap - 1, 0))
    eidx = torch.where(is_p, pm[ordp[pu_c]], gv[gj])

    e_oh, e_pos, e_rec, e_asm = _emitted_streams(codes_aug, eidx, k, starts, rec_base, asm_tab)
    return e_oh, e_pos, e_rec, dev_count, e_asm
