"""The minimizer graph, its penalties, the threshold and the filter.

Upstream Seqwin's graph contract (the arrays `results.seqwin` keeps):
- k-mers: (pos, record_idx) of every emitted minimizer, grouped by node in
  ascending unsigned node id, each group in scan order (assembly, record,
  position);
- nodes: (hash, start, stop, n_tar, n_neg, penalty), ``[start, stop)`` the
  node's k-mer group, n_tar / n_neg the target / non-target assemblies that
  hold it, penalty ``sqrt((1 - n_tar/N_tar)^2 + (n_neg/N_neg)^2)``;
- edges: (first, second, weight) for every pair of minimizers adjacent in a
  record, ``first <= second``, weight the number of assemblies with that
  adjacency, sorted by (first, second).

The threshold comes from two expectations (without Mash: from the
minimizer counts here; with sketches: `sketches.py`), scaled by the
stringency and capped. The filter keeps edges
heavier than the truncated edge-weight threshold and the nodes they touch.
All of it in float64 unless ``dtype`` says otherwise (the control).
"""
from __future__ import annotations

import numpy as np
import torch

KMER_DTYPE = np.dtype([('pos', np.uint32), ('record_idx', np.uint32)])
NODE_DTYPE = np.dtype([('hash', np.uint64), ('start', np.uintp), ('stop', np.uintp),
                       ('n_tar', np.uint32), ('n_neg', np.uint32), ('penalty', np.float64)])
EDGE_DTYPE = np.dtype([('first', np.uint64), ('second', np.uint64), ('weight', np.uintp)])

SIGN = -(1 << 63)


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint64)


def _starts(*cols: torch.Tensor) -> torch.Tensor:
    """Flags: row 0, and every row where any column changes."""
    flag = torch.zeros(cols[0].numel(), dtype=torch.bool, device=cols[0].device)
    flag[:1] = True
    for c in cols:
        flag[1:] |= c[1:] != c[:-1]
    return flag


def _run_sums(flags: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Sum of ``flags`` over each run from one start to the next."""
    if starts.numel() == 0:
        return starts
    c = torch.cat([torch.zeros(1, dtype=torch.int64, device=flags.device), torch.cumsum(flags.long(), 0)])
    ends = torch.cat([starts[1:], torch.tensor([flags.numel()], device=flags.device)])
    return c[ends] - c[starts]


def aggregate(node_id, pos, rec, asm, edge_u, edge_v, edge_asm, is_target: np.ndarray):
    """(kmers, nodes, edges) from the scan-ordered minimizer stream and the
    adjacent pairs (``edge_u <= edge_v`` unsigned), all int64 tensors on one
    device; penalties left 0."""
    dev = node_id.device
    order = torch.sort(node_id ^ SIGN, stable=True).indices
    s_id, s_asm = node_id[order], asm[order]
    new_node = _starts(s_id)
    first_in_asm = _starts(s_id, s_asm)
    tgt = torch.from_numpy(np.asarray(is_target, dtype=bool)).to(dev)[s_asm]
    starts = torch.nonzero(new_node).flatten()
    kmers = np.zeros(node_id.numel(), dtype=KMER_DTYPE)
    kmers['pos'] = pos[order].cpu().numpy()
    kmers['record_idx'] = rec[order].cpu().numpy()
    nodes = np.zeros(starts.numel(), dtype=NODE_DTYPE)
    nodes['hash'] = _u64(s_id[starts])
    nodes['start'] = starts.cpu().numpy()
    nodes['stop'] = np.append(nodes['start'][1:], node_id.numel())
    nodes['n_tar'] = _run_sums(first_in_asm & tgt, starts).cpu().numpy()
    nodes['n_neg'] = _run_sums(first_in_asm & ~tgt, starts).cpu().numpy()

    perm = torch.arange(edge_u.numel(), device=dev)
    for col in (edge_asm, edge_v ^ SIGN, edge_u ^ SIGN):
        perm = perm[torch.sort(col[perm], stable=True).indices]
    u, v, a = edge_u[perm], edge_v[perm], edge_asm[perm]
    new_edge = _starts(u, v)
    e_starts = torch.nonzero(new_edge).flatten()
    edges = np.zeros(e_starts.numel(), dtype=EDGE_DTYPE)
    edges['first'] = _u64(u[e_starts])
    edges['second'] = _u64(v[e_starts])
    edges['weight'] = _run_sums(_starts(u, v, a), e_starts).cpu().numpy()
    return kmers, nodes, edges


def set_penalties(nodes: np.ndarray, n_tar: int, n_neg: int, dtype=np.float64) -> None:
    frac_tar = nodes['n_tar'].astype(dtype) / dtype(n_tar)
    frac_neg = nodes['n_neg'].astype(dtype) / dtype(n_neg)
    nodes['penalty'] = ((1 - frac_tar) ** 2 + frac_neg ** 2) ** 0.5


def minimizer_expectations(nodes: np.ndarray, n_tar: int, n_neg: int, dtype=np.float64):
    """Upstream's estimate without Mash: (expected absence of a target
    minimizer in targets, its expected presence in non-targets), weighted by
    target counts."""
    t = nodes['n_tar'].astype(dtype)
    total = t.sum()
    e_absence_tar = 1 - (t / dtype(n_tar) * t).sum() / total
    e_presence_neg = (nodes['n_neg'].astype(dtype) / dtype(n_neg) * t).sum() / total
    return e_absence_tar, e_presence_neg


def penalty_threshold(e_absence_tar, e_presence_neg, stringency: int, cap: float,
                      dtype=np.float64) -> tuple[float, float]:
    """(calculated, capped) threshold from the two expectations, scaled by
    the stringency."""
    th = dtype(1 - stringency / 10) * (e_absence_tar * e_presence_neg) ** dtype(0.5)
    return float(th), float(min(th, dtype(cap)))


def edge_weight_threshold(penalty_th: float, n_tar: int, mul: float) -> float:
    return mul * (1 - penalty_th) * n_tar


def kept_edges(edges: np.ndarray, weight_th: float) -> np.ndarray:
    """Edges heavier than the threshold truncated to an integer."""
    return edges[edges['weight'] > np.uintp(weight_th)]


def compact(kmers: np.ndarray, nodes: np.ndarray, used: np.ndarray):
    """The k-mers and nodes of the ``used`` node ids, node ranges rebased."""
    keep = np.isin(nodes['hash'], used)
    out = nodes[keep].copy()
    sizes = (out['stop'] - out['start']).astype(np.int64)
    stops = np.cumsum(sizes)
    src = np.concatenate([np.arange(s, e, dtype=np.int64)
                          for s, e in zip(out['start'].tolist(), out['stop'].tolist())]
                         or [np.zeros(0, np.int64)])
    out['start'] = stops - sizes
    out['stop'] = stops
    return kmers[src], out
