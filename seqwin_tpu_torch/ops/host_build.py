"""Vectorized NumPy reference builder (the `backend='numpy'` engine).

Counterpart: `seqwin_tpu/ops/host_build.py` (copied; the port never imports
the JAX package).

A device-free implementation of the full graph build with O(n) numpy passes:
slabbed table-lookup ntHash (`ops/host_hash.py`), a two-block rightmost-argmin
sliding window in valid-k-mer index space, emit-on-advance, and lexsort-based
aggregation. Bit-exact vs both the per-position oracle (`ops/oracle.py`,
differentially fuzz-tested) and the device engine; fast enough for the
171-genome golden gate (`tests/run_golden171.py`), where the per-position
oracle's Python loops are impractical.

Reference contract: the reference's `cpp/vendor/btllib/minimizer.cpp:14-49`
(rightmost tie, emit on position advance), the reference's `cpp/src/seqwin/
graph.cpp:127-159` + `helpers.cpp:161-297` (once-per-assembly counts, edge
weights, hash-grouped k-mers in scan order).
"""
from __future__ import annotations

import numpy as np

from .hashing import M64, out_hash_mult
from .host_hash import canon_at

_SLAB = 1 << 20  # positions per canon_at slab (bounds gather temporaries)


def _canon_slabbed(codes: np.ndarray, pos: np.ndarray, k: int) -> np.ndarray:
    out = np.empty(len(pos), dtype=np.uint64)
    for lo in range(0, len(pos), _SLAB):
        sl = pos[lo:lo + _SLAB]
        out[lo:lo + len(sl)] = canon_at(codes, sl, k)
    return out


def _rightmost_argmin_windows(mh: np.ndarray, w: int) -> np.ndarray:
    """For each window of ``w`` consecutive entries, the index of the
    minimum, ties resolved to the RIGHTMOST (btllib `<=` rescan semantics).

    Returns int64[M - w + 1]; entry i is the argmin over [i, i + w).
    """
    M = len(mh)
    n_win = M - w + 1
    idx = np.arange(M, dtype=np.int64)
    blk = idx // w
    blk_start = blk * w

    # prefix: per-block running min (log-doubling with block reset)
    run = mh.copy()
    shift = 1
    while shift < w:
        cand = np.empty_like(run)
        cand[:shift] = run[:shift]
        cand[shift:] = run[:-shift]
        take = (idx % w >= shift) & (cand < run)
        run = np.where(take, cand, run)
        shift <<= 1
    # run[j] = min over [block_start, j]. rightmost index attaining it:
    new_min = np.empty(M, dtype=bool)
    new_min[0] = True
    new_min[1:] = (mh[1:] <= run[:-1]) | (idx[1:] % w == 0)
    pre_idx = np.maximum.accumulate(np.where(new_min, idx, -1))
    # reset accumulate at block starts: since new_min is True at every block
    # start, the accumulated index never crosses a boundary.

    # suffix: rightmost min over [j, block_end); scan right-to-left, update
    # only on strictly-smaller (keeps the rightmost on ties)
    r = mh[::-1]
    ridx = idx[::-1]
    rpos_in_blk = (w - 1) - (ridx % w)  # 0 at block end
    rrun = r.copy()
    shift = 1
    while shift < w:
        cand = np.empty_like(rrun)
        cand[:shift] = rrun[:shift]
        cand[shift:] = rrun[:-shift]
        take = (rpos_in_blk >= shift) & (cand < rrun)
        rrun = np.where(take, cand, rrun)
        shift <<= 1
    # rrun (reversed) = min over [j, block_end). rightmost index attaining it:
    new_min_r = np.empty(M, dtype=bool)
    new_min_r[0] = True
    new_min_r[1:] = (r[1:] < rrun[:-1]) | (rpos_in_blk[1:] == 0)
    suf_idx = np.maximum.accumulate(np.where(new_min_r, M - 1 - ridx, -1))
    suf_idx = (M - 1) - suf_idx[::-1]
    suf_val = rrun[::-1]

    # window [l, l + w): spans blocks [l, B) and [B, l + w - 1] with
    # B = block_start(r_end). When l is itself a block start the window is
    # exactly one block and pre alone answers it.
    l = np.arange(n_win, dtype=np.int64)
    r_end = l + w - 1
    one_block = (l % w) == 0
    v_pre = run[r_end]  # min over [B, r_end]
    i_pre = pre_idx[r_end]
    v_suf = suf_val[l]  # min over [l, B)
    i_suf = suf_idx[l]
    # the pre candidate lives in the later block -> wins ties
    use_pre = one_block | (v_pre <= v_suf)
    return np.where(use_pre, i_pre, i_suf)


def minimize_record(codes: np.ndarray, k: int, w: int):
    """Emitted minimizers of one record: (out_hash u64[E], pos int64[E]).

    Exact `ops/oracle.py::minimize` semantics, vectorized.
    """
    n = len(codes)
    empty = (np.zeros(0, np.uint64), np.zeros(0, np.int64))
    if k > n:
        return empty
    invalid = (codes > 3).astype(np.int64)
    cs = np.concatenate(([0], np.cumsum(invalid)))
    valid = (cs[k:] - cs[:-k]) == 0  # [n - k + 1]
    pos = np.flatnonzero(valid)
    if len(pos) < w:
        return empty
    mh = _canon_slabbed(codes, pos, k)

    sel = _rightmost_argmin_windows(mh, w)
    zpos = pos[sel]
    # emit when the window minimum's position advances (zpos is monotone
    # non-decreasing under sliding for rightmost-tie argmin)
    emit = np.empty(len(sel), dtype=bool)
    emit[0] = True
    emit[1:] = zpos[1:] > zpos[:-1]
    emit &= mh[sel] != np.uint64(M64)
    esel = sel[emit]

    mult = np.uint64(out_hash_mult(k))
    with np.errstate(over='ignore'):
        t = mh[esel] * mult
    oh = t ^ (t >> np.uint64(27))
    return oh, pos[esel].astype(np.int64)


def build_graph_vec(
    record_seqs: list[list[np.ndarray]],
    k: int,
    w: int,
    is_targets: list[bool],
):
    """Vectorized full-graph build; same contract as `oracle.build_graph`."""
    from ..graph.dtypes import EDGE_DTYPE, KMER_DTYPE, NODE_DTYPE

    oh_l, pos_l, rec_l, asm_l = [], [], [], []
    eu_l, ev_l, ea_l = [], [], []
    record_offsets = [0]
    rec = 0
    for ai, records in enumerate(record_seqs):
        for codes in records:
            oh, pos = minimize_record(np.asarray(codes, dtype=np.uint8), k, w)
            if len(oh):
                oh_l.append(oh)
                pos_l.append(pos)
                rec_l.append(np.full(len(oh), rec, np.int64))
                asm_l.append(np.full(len(oh), ai, np.int64))
                if len(oh) > 1:
                    eu_l.append(np.minimum(oh[:-1], oh[1:]))
                    ev_l.append(np.maximum(oh[:-1], oh[1:]))
                    ea_l.append(np.full(len(oh) - 1, ai, np.int64))
            rec += 1
        record_offsets.append(rec)

    if not oh_l:
        return (np.zeros(0, KMER_DTYPE), np.zeros(0, NODE_DTYPE),
                np.zeros(0, EDGE_DTYPE), np.array(record_offsets, np.uintp))
    oh = np.concatenate(oh_l)
    pos = np.concatenate(pos_l)
    recs = np.concatenate(rec_l)
    asm = np.concatenate(asm_l)
    tgt = np.asarray(is_targets, dtype=bool)

    # nodes + grouped kmers: stable sort by hash keeps global scan order
    # within each hash group (reference merge contract, helpers.cpp:161-229)
    order = np.argsort(oh, kind='stable')
    s_oh, s_pos, s_rec, s_asm = oh[order], pos[order], recs[order], asm[order]
    boundary = np.empty(len(s_oh), dtype=bool)
    boundary[0] = True
    boundary[1:] = s_oh[1:] != s_oh[:-1]
    first_occ = boundary.copy()
    first_occ[1:] |= s_asm[1:] != s_asm[:-1]
    starts = np.flatnonzero(boundary)
    stops = np.concatenate((starts[1:], [len(s_oh)]))
    n_tar = np.add.reduceat((first_occ & tgt[s_asm]).astype(np.int64), starts)
    n_neg = np.add.reduceat((first_occ & ~tgt[s_asm]).astype(np.int64), starts)

    kmers = np.zeros(len(s_oh), dtype=KMER_DTYPE)
    kmers['pos'] = s_pos
    kmers['record_idx'] = s_rec
    nodes = np.zeros(len(starts), dtype=NODE_DTYPE)
    nodes['hash'] = s_oh[starts]
    nodes['start'] = starts
    nodes['stop'] = stops
    nodes['n_tar'] = n_tar
    nodes['n_neg'] = n_neg

    if eu_l:
        eu = np.concatenate(eu_l)
        ev = np.concatenate(ev_l)
        ea = np.concatenate(ea_l)
        eorder = np.lexsort((ea, ev, eu))
        t_u, t_v, t_a = eu[eorder], ev[eorder], ea[eorder]
        new_edge = np.empty(len(t_u), dtype=bool)
        new_edge[0] = True
        new_edge[1:] = (t_u[1:] != t_u[:-1]) | (t_v[1:] != t_v[:-1])
        new_triple = new_edge.copy()
        new_triple[1:] |= t_a[1:] != t_a[:-1]
        estarts = np.flatnonzero(new_edge)
        edges = np.zeros(len(estarts), dtype=EDGE_DTYPE)
        edges['first'] = t_u[estarts]
        edges['second'] = t_v[estarts]
        edges['weight'] = np.add.reduceat(new_triple.astype(np.int64), estarts)
    else:
        edges = np.zeros(0, dtype=EDGE_DTYPE)

    return kmers, nodes, edges, np.array(record_offsets, dtype=np.uintp)
