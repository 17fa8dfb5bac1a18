"""Upstream Seqwin's candidate markers, one per kept subgraph.

For each subgraph, in order, its k-mers (the node groups in the subgraph's
iteration order) are located:
1. sorted by (assembly, record, position);
2. cut into runs where the position gap on the sorted stream exceeds
   1.5 * w, or the assembly or record changes;
3. per assembly the longest run is kept (the first on ties); the run count
   is its repeats; the span ends k bases past the last position.
The representative order is the most common canonical k-mer order among
the targets (canonical: the smaller of the order and its reverse; weight:
length times count; ties: first seen), oriented as the more frequent of the
two. Warnings: a single k-mer, duplicate k-mers, a non-linear or
multi-path subgraph, a graph path inconsistent with the representative. A
candidate is bad with 'single', 'dup' or 'rev', and is kept when not bad and
at least ``min_len`` long.
"""
from __future__ import annotations

from collections import Counter

import numpy as np

GAP_MUL = 1.5
_BAD = frozenset(('single', 'dup', 'rev'))


class Ordered(tuple):
    """Ordered k-mer ids and the strand of another order against them."""

    def __new__(cls, kmers):
        return super().__new__(cls, kmers)

    def __init__(self, kmers) -> None:
        self.rev = self[::-1]
        self.index = {kmer: i for i, kmer in enumerate(self)}
        self.is_dup = len(self.index) < len(self)

    def strand(self, kmers) -> str:
        if kmers == self:
            return '+'
        if kmers == self.rev:
            return '-'
        if len(kmers) == 1:
            return 'u' if kmers[0] in self.index else '?'
        if not self.is_dup:
            idx = [self.index[k] for k in kmers if k in self.index]
            if len(idx) == 1:
                return 'u'
            if not idx:
                return '?'
            if idx == sorted(idx):
                return '+'
            if idx == sorted(idx, reverse=True):
                return '-'
            return '?'
        shared = tuple(k for k in kmers if k in self.index)
        if len(shared) == 1:
            return 'u'
        if not shared:
            return '?'

        def contains(order) -> bool:
            i = 0
            for kmer in order:
                if kmer == shared[i]:
                    i += 1
                    if i == len(shared):
                        return True
            return False

        if contains(self):
            return '+'
        if contains(self.rev):
            return '-'
        return '?'


def locate(ids, pos, asm, rec, k: int, w: int, n_tar: int) -> list[dict]:
    order = np.lexsort((pos, rec, asm))
    ids, pos, asm, rec = ids[order], pos[order].astype(np.int64), asm[order], rec[order]
    n = len(pos)
    cut = np.zeros(n, dtype=bool)
    cut[0] = True
    if n > 1:
        cut[1:] = (np.diff(pos) > GAP_MUL * w) | (asm[1:] != asm[:-1]) | (rec[1:] != rec[:-1])
    starts = np.flatnonzero(cut)
    stops = np.append(starts[1:], n)
    locs = []
    g = 0
    while g < len(starts):
        a = asm[starts[g]]
        best, runs = g, 0
        while g < len(starts) and asm[starts[g]] == a:
            if stops[g] - starts[g] > stops[best] - starts[best]:
                best = g
            runs += 1
            g += 1
        s, e = int(starts[best]), int(stops[best])
        start, stop = int(pos[s]), int(pos[e - 1]) + k
        locs.append(dict(assembly_idx=int(a), record_idx=int(rec[s]), start=start, stop=stop,
                         n_kmers=e - s, kmers=tuple(int(h) for h in ids[s:e]),
                         is_target=bool(a < n_tar), n_repeats=runs, len=stop - start))
    return locs


def _representative(locs: list[dict], warnings: set) -> tuple[Ordered, int]:
    c = Counter(loc['kmers'] for loc in locs if loc['is_target'])
    canonical: Counter = Counter()
    for kmers, count in c.items():
        canonical[min(kmers, kmers[::-1])] += count
    best = max(canonical, key=lambda km: len(km) * canonical[km])
    rep = Ordered(max((best, best[::-1]), key=lambda km: c[km]))
    if len(rep) == 1:
        warnings.add('single')
    if rep.is_dup:
        warnings.add('dup')
    return rep, canonical[best]


def _simple_paths(adj: dict, source, target):
    """Every simple path from source to target, depth first in adjacency
    order."""
    path, on_path, stack = [source], {source}, [iter(adj[source])]
    while stack:
        child = next(stack[-1], None)
        if child is None:
            stack.pop()
            on_path.discard(path.pop())
        elif child in on_path:
            continue
        elif child == target:
            yield path + [child]
        else:
            path.append(child)
            on_path.add(child)
            stack.append(iter(adj[child]))


def _graph_order(adj: dict, rep: Ordered, warnings: set):
    def degree(n):
        return len(adj[n]) + (n in adj[n])

    leaves = tuple(n for n in adj if degree(n) == 1)
    if len(leaves) != 2:
        warnings.add('non-linear')
        return None
    paths = list(_simple_paths(adj, *leaves))
    if len(paths) == 1:
        order = paths[0]
    else:
        warnings.add('multi-paths')
        order = None
        for p in paths:
            p = tuple(p)
            if p == rep:
                order = p
                break
            if p == rep.rev:
                order = p[::-1]
                break
        if order is None:
            order = max(paths, key=len)
    if rep.strand(tuple(order)) == '-':
        order = tuple(order)[::-1]
    order = Ordered(order)
    if order != rep:
        warnings.add('inconsistent')
    return order


def candidate(adj: dict, rows, k: int, w: int, n_tar: int) -> dict:
    """One subgraph's candidate from its adjacency (the parent's order) and
    its k-mer rows (id, pos, assembly, record within the assembly)."""
    warnings: set[str] = set()
    locs = locate(*rows, k, w, n_tar)
    rep_order, n_rep = _representative(locs, warnings)
    rep = next(loc for loc in locs if loc['kmers'] == rep_order)
    path = _graph_order(adj, rep_order, warnings)
    return dict(path=None if path is None else tuple(path), rep=rep, len=rep['len'],
                n_rep=n_rep, warnings=tuple(sorted(warnings)),
                is_bad=bool(warnings & _BAD))


def candidate_star(args):
    return candidate(*args)
