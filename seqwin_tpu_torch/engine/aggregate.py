"""Graph aggregation: minimizer stream -> nodes / edges / grouped k-mers.

Counterpart: `seqwin_tpu/engine/aggregate.py` (`_compact_chunks`,
`_merge_nodes`, `_merge_edges` hash-key route, `_extract_ascending`,
`parallel/distributed.py::_reduce_edges`, the
edge filter and k-mer compaction gathers, `DeviceGraph`, `HostGraph`,
`aggregate_device`, `aggregate`; the timeline marks
``agg_merge_nodes_done`` and ``agg_kn_d2h_done``). Output contract:

- nodes sorted by unsigned hash; k-mers grouped per node in global
  (assembly, record, pos) scan order (a stable sort of the scan-ordered
  stream);
- per-(hash, assembly) deduplicated n_tar / n_neg counts;
- undirected edges canonicalised u <= v, weight = number of assemblies in
  which the endpoints are adjacent at least once, sorted by (first, second).

Hashes are int64 bit patterns (`ops/u64.py`); every sort and compare on them
goes through the sign-flipped key. The chunk scans hand over exact-length
streams, so no padding rides the sorts.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..graph.dtypes import EDGE_DTYPE, KMER_DTYPE, NODE_DTYPE
from ..ops import u64
from . import timeline


def _extract_ascending(flags: torch.Tensor) -> torch.Tensor:
    """Indices (ascending) of the set flags."""
    return torch.nonzero(flags).flatten()


def _lex_argsort(*cols: torch.Tensor) -> torch.Tensor:
    """Permutation sorting rows by (cols[0], cols[1], ...) ascending, by LSD
    passes of stable single-key sorts."""
    perm = torch.arange(cols[0].numel(), device=cols[0].device)
    for c in reversed(cols):
        perm = perm[torch.sort(c[perm], stable=True).indices]
    return perm


def _changes(x: torch.Tensor) -> torch.Tensor:
    """flag[i] = i == 0 or x[i] != x[i-1]."""
    return torch.cat([torch.ones(min(1, x.numel()), dtype=torch.bool, device=x.device),
                      x[1:] != x[:-1]])


def _segment_sums(flags: torch.Tensor, starts: torch.Tensor, stops: torch.Tensor):
    """Sum of ``flags`` over each [start, stop)."""
    c = torch.cat([torch.zeros(1, dtype=torch.int64, device=flags.device),
                   torch.cumsum(flags.long(), 0)])
    return c[stops] - c[starts]


def _compact_chunks(chunks):
    """Concatenate the exact-length chunk streams in global scan order."""
    return tuple(torch.cat([c[i] for c in chunks]) for i in (0, 1, 2, 4))


def _merge_nodes(oh, pos, rec, asm, is_target):
    """Sort the stream by hash (stable: scan order within a hash run) and
    reduce runs into node records.

    Returns sorted (pos, rec) [the kmers array] and per-node
    (hash, start, stop, n_tar, n_neg)."""
    order = torch.sort(u64.key(oh), stable=True).indices
    s_oh, s_pos, s_rec, s_asm = oh[order], pos[order], rec[order], asm[order]
    boundary = _changes(s_oh)
    # scan order keeps each assembly's entries of a hash run contiguous, so
    # an assembly change marks a new (hash, assembly) pair
    first_occ = boundary | _changes(s_asm)
    tgt = is_target[s_asm]
    starts = _extract_ascending(boundary)
    stops = torch.cat([starts[1:], torch.full((1,), oh.numel(), device=oh.device)])
    n_tar = _segment_sums(first_occ & tgt, starts, stops)
    n_neg = _segment_sums(first_occ & ~tgt, starts, stops)
    return s_pos, s_rec, s_oh[starts], starts, stops, n_tar, n_neg


def _reduce_edges(u, v, asm):
    """Edge reduction of canonical pairs (u <= v unsigned): distinct (u, v)
    with weight = number of distinct assemblies, sorted by (first, second)
    unsigned. Shared by the single-device merge and the multi-device owner
    merge."""
    perm = _lex_argsort(u64.key(u), u64.key(v), asm)
    t_u, t_v, t_a = u[perm], v[perm], asm[perm]
    new_edge = _changes(t_u) | _changes(t_v)
    new_triple = new_edge | _changes(t_a)
    starts = _extract_ascending(new_edge)
    stops = torch.cat([starts[1:], torch.full((1,), t_u.numel(), device=u.device)])
    return t_u[starts], t_v[starts], _segment_sums(new_triple, starts, stops)


def _merge_edges(oh, rec, asm):
    """Canonicalised adjacent-pair edges with per-assembly dedup.

    Returns (first, second, weight), sorted by (first, second) unsigned."""
    adj = rec[:-1] == rec[1:]
    a, b = oh[:-1][adj], oh[1:][adj]
    return _reduce_edges(u64.umin(a, b), u64.umax(a, b), asm[:-1][adj])


def _kmers_host(pos: torch.Tensor, rec: torch.Tensor) -> np.ndarray:
    kmers = np.zeros(pos.numel(), dtype=KMER_DTYPE)
    kmers['pos'] = pos.cpu().numpy()
    kmers['record_idx'] = rec.cpu().numpy()
    return kmers


def _nodes_host(node_hash, starts, stops, n_tar, n_neg, base: int = 0) -> np.ndarray:
    """NODE_DTYPE array; k-mer ranges shifted by ``base``."""
    nodes = np.zeros(node_hash.numel(), dtype=NODE_DTYPE)
    nodes['hash'] = u64.to_numpy(node_hash)
    nodes['start'] = starts.cpu().numpy() + base
    nodes['stop'] = stops.cpu().numpy() + base
    nodes['n_tar'] = n_tar.cpu().numpy()
    nodes['n_neg'] = n_neg.cpu().numpy()
    return nodes


def _edges_host(first: torch.Tensor, second: torch.Tensor, weight: torch.Tensor) -> np.ndarray:
    edges = np.zeros(first.numel(), dtype=EDGE_DTYPE)
    edges['first'] = u64.to_numpy(first)
    edges['second'] = u64.to_numpy(second)
    edges['weight'] = weight.cpu().numpy()
    return edges


class DeviceGraph:
    """Deferred aggregation result: nodes on the host, the grouped k-mer
    stream and the merged edges resident on the device.

    The pipeline asks for exactly what it needs: full nodes at build time
    (penalty and threshold math is host float64), weight-filtered edges once
    the threshold is known, and the compacted k-mers of the kept nodes after
    subgraph search. `materialize()` gives the full arrays. ``n_chunks`` is
    the number of chunks scanned on the device, one phase-1 launch each.
    """

    def __init__(self, nodes, s_pos, s_rec, n_starts, n_stops,
                 e_first, e_second, e_weight, n_chunks: int = 0):
        self.nodes = nodes
        self._s_pos, self._s_rec = s_pos, s_rec
        self._n_starts, self._n_stops = n_starts, n_stops
        self._e_first, self._e_second, self._e_weight = e_first, e_second, e_weight
        self.n_kmers = s_pos.numel()
        self.n_nodes = len(nodes)
        self.n_edges = e_first.numel()
        self.n_chunks = n_chunks
        self.record_codes = None

    def materialize(self) -> tuple[np.ndarray, np.ndarray]:
        """Full (kmers, edges) host arrays."""
        return _kmers_host(self._s_pos, self._s_rec), self.materialize_edges()

    def materialize_edges(self) -> np.ndarray:
        return _edges_host(self._e_first, self._e_second, self._e_weight)

    def filter_edges(self, weight_th) -> np.ndarray:
        """EDGE_DTYPE survivors of ``weight > uintp(weight_th)`` (a float
        threshold truncates, as in the host filter); only they leave the
        device."""
        sel = self._e_weight > int(np.uintp(weight_th))
        return _edges_host(self._e_first[sel], self._e_second[sel], self._e_weight[sel])

    def compact_kmers(self, keep: np.ndarray, total: int) -> np.ndarray:
        """KMER_DTYPE entries of nodes flagged in ``keep`` (bool[n_nodes]):
        segments in node order, entries in scan order."""
        dev = self._s_pos.device
        keep_d = torch.from_numpy(np.asarray(keep, dtype=bool)).to(dev)
        starts = self._n_starts[keep_d]
        sizes = self._n_stops[keep_d] - starts
        seg = torch.repeat_interleave(torch.arange(starts.numel(), device=dev),
                                      sizes, output_size=total)
        base = torch.cumsum(sizes, 0) - sizes
        src = starts[seg] + torch.arange(total, device=dev) - base[seg]
        return _kmers_host(self._s_pos[src], self._s_rec[src])

    def release(self) -> None:
        """Drop the device references."""
        self._s_pos = self._s_rec = None
        self._n_starts = self._n_stops = None
        self._e_first = self._e_second = self._e_weight = None
        self.record_codes = None


class HostGraph:
    """Host-array implementation of the `DeviceGraph` interface (empty,
    multi-device and host builds)."""

    def __init__(self, kmers: np.ndarray, nodes: np.ndarray, edges: np.ndarray,
                 n_chunks: int = 0):
        self.nodes = nodes
        self._kmers = kmers
        self._edges = edges
        self.n_kmers = len(kmers)
        self.n_nodes = len(nodes)
        self.n_edges = len(edges)
        self.n_chunks = n_chunks
        self.record_codes = None

    def materialize(self) -> tuple[np.ndarray, np.ndarray]:
        return self._kmers, self._edges

    def materialize_edges(self) -> np.ndarray:
        return self._edges

    def filter_edges(self, weight_th) -> np.ndarray:
        return self._edges[self._edges['weight'] > np.uintp(weight_th)]

    def compact_kmers(self, keep: np.ndarray, total: int) -> np.ndarray:
        kept = self.nodes[keep]
        sizes = (kept['stop'] - kept['start']).astype(np.int64)
        new_stops = np.cumsum(sizes)
        if total == 0:
            return np.zeros(0, dtype=KMER_DTYPE)
        seg_idx = (np.arange(total, dtype=np.int64)
                   + np.repeat(kept['start'].astype(np.int64) - (new_stops - sizes), sizes))
        return self._kmers[seg_idx]

    def release(self) -> None:
        self._kmers = self._edges = None
        self.record_codes = None


def aggregate_device(chunks, is_target: np.ndarray, defer: bool = False):
    """Aggregate device-resident chunk results into (kmers, nodes, edges).

    Args:
        chunks: list of (e_oh, e_pos, e_rec, count, e_asm) from
            `hybrid.scan_chunk_device` (or `hybrid.scan_blocks`,
            `minimizer.scan_chunk_sort`), exact-length streams in global
            scan order. A record split into blocks spans several chunks;
            its junction edges need no extra pairs, as the last kept
            emission of one block and the first of the next sit side by
            side in the concatenated stream, with the same record index.
        is_target: bool[A].
        defer: return a `DeviceGraph` (nodes on host, kmers/edges on the
            device) instead of the (kmers, nodes, edges) tuple.

    The chunk streams may be views of longer buffers (the deferred scan's
    emission slots, trimmed); the concatenation copies what they hold.
    """
    n_chunks = sum(c[0] is not None for c in chunks)
    chunks = [c for c in chunks if c[0] is not None and c[3] > 0]
    if not chunks:
        empty = (np.zeros(0, KMER_DTYPE), np.zeros(0, NODE_DTYPE), np.zeros(0, EDGE_DTYPE))
        return HostGraph(*empty, n_chunks=n_chunks) if defer else empty
    oh, pos, rec, asm = _compact_chunks(chunks)
    tmask = torch.from_numpy(np.asarray(is_target, dtype=bool)).to(oh.device)
    s_pos, s_rec, node_hash, n_starts, n_stops, n_tar, n_neg = _merge_nodes(
        oh, pos, rec, asm, tmask)
    timeline.mark('agg_merge_nodes_done')
    nodes = _nodes_host(node_hash, n_starts, n_stops, n_tar, n_neg)
    # the deferred graph ships the node columns only; the k-mers stay
    kmers = None if defer else _kmers_host(s_pos, s_rec)
    timeline.mark('agg_kn_d2h_done', bytes=nodes.nbytes + (0 if defer else kmers.nbytes))
    e_first, e_second, e_weight = _merge_edges(oh, rec, asm)
    graph = DeviceGraph(nodes, s_pos, s_rec, n_starts, n_stops,
                        e_first, e_second, e_weight, n_chunks=n_chunks)
    if defer:
        return graph
    return kmers, nodes, graph.materialize_edges()


def aggregate(oh: np.ndarray, pos: np.ndarray, rec: np.ndarray, asm: np.ndarray,
              is_target: np.ndarray, record_offsets: np.ndarray | None = None,
              device=None) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """NumPy-input wrapper around `aggregate_device` (trimmed scan-order
    arrays in, structured arrays out). The assembly of each entry comes from
    ``record_offsets``; without them, from the contiguous per-assembly
    record ranges that the (rec, asm) pairs imply."""
    dev = resolve_device(device)
    m = len(oh)
    if m == 0:
        return (np.zeros(0, KMER_DTYPE), np.zeros(0, NODE_DTYPE), np.zeros(0, EDGE_DTYPE))
    rec = np.asarray(rec, np.int64)
    if record_offsets is None:
        hi_per_asm = np.full(len(is_target), -1, dtype=np.int64)
        np.maximum.at(hi_per_asm, np.asarray(asm, np.int64), rec)
        record_offsets = np.zeros(len(is_target) + 1, dtype=np.int64)
        record_offsets[1:] = np.maximum.accumulate(hi_per_asm) + 1
    asm = np.searchsorted(np.asarray(record_offsets, np.int64), rec, side='right') - 1

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(dev)

    chunk = (u64.from_numpy(oh, dev), t(pos), t(rec), m, t(asm))
    return aggregate_device([chunk], is_target)
