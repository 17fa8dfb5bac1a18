"""Minimal insertion-ordered undirected graph + k-mer ordering helpers.

Counterpart: `seqwin_tpu/graph/hashgraph.py` (a copy, with `subgraph`'s
``order`` added).

`HashGraph` is a deliberate, dependency-free stand-in for the small slice of
networkx behavior the marker pipeline depends on. Output bit-exactness
requires matching networkx's *iteration orders*, which all derive from dict
insertion order (the reference's graph construction and its linearity /
path checks). The contract:

- nodes appear in first-insertion order (edge endpoints inserted first->second
  per edge, edges processed in sorted (first, second) order);
- ``neighbors`` iterate in edge-insertion order;
- ``degree`` counts self-loops twice (networkx convention);
- ``subgraph`` preserves the parent's node and neighbor orders;
- ``all_simple_paths`` enumerates in adjacency-order DFS (networkx order).

`OrderedKmers` mirrors the reference's ordered k-mer helper.
"""
from __future__ import annotations

from collections.abc import Iterable, Iterator


class HashGraph:
    """Undirected graph over hashable nodes with insertion-ordered adjacency."""

    __slots__ = ('_adj',)

    def __init__(self) -> None:
        self._adj: dict = {}

    def add_edge(self, u, v) -> None:
        if u not in self._adj:
            self._adj[u] = {}
        if v not in self._adj:
            self._adj[v] = {}
        self._adj[u][v] = None
        self._adj[v][u] = None

    def add_edges(self, edges: Iterable[tuple]) -> None:
        for u, v in edges:
            self.add_edge(u, v)

    def __contains__(self, n) -> bool:
        return n in self._adj

    def __iter__(self) -> Iterator:
        return iter(self._adj)

    def __len__(self) -> int:
        return len(self._adj)

    def nodes(self):
        return self._adj.keys()

    def neighbors(self, n):
        return self._adj[n].keys()

    def degree(self, n) -> int:
        # self-loop counts twice, matching networkx
        return len(self._adj[n]) + (1 if n in self._adj[n] else 0)

    def subgraph(self, nbunch, order: dict | None = None) -> 'HashGraph':
        """The subgraph induced by the nodes of ``nbunch`` that are in the
        graph, in the parent's node and neighbour orders. ``order`` maps every
        node to its insertion rank (``{n: i for i, n in enumerate(graph)}``,
        built here when not given): a caller cutting many subgraphs passes
        one map, so each costs its own nodes' degrees, not the whole graph."""
        adj = self._adj
        if order is None:
            order = {n: i for i, n in enumerate(adj)}
        keep = {n for n in nbunch if n in adj}
        g = HashGraph.__new__(HashGraph)
        g._adj = {
            n: {m: None for m in adj[n] if m in keep}
            for n in sorted(keep, key=order.__getitem__)
        }
        return g

    def all_simple_paths(self, source, target) -> Iterator[list]:
        """All simple paths source->target, adjacency-order DFS (nx order)."""
        adj = self._adj
        if source not in adj or target not in adj:
            return
        path = [source]
        on_path = {source}
        stack = [iter(adj[source])]
        while stack:
            children = stack[-1]
            child = next(children, None)
            if child is None:
                stack.pop()
                on_path.discard(path.pop())
                continue
            if child in on_path:
                continue
            if child == target:
                yield path + [child]
                continue
            path.append(child)
            on_path.add(child)
            stack.append(iter(adj[child]))


class OrderedKmers(tuple):
    """Ordered k-mer hashes with strand comparison."""

    def __new__(cls, kmers: Iterable[int]):
        return super().__new__(cls, kmers)

    def __init__(self, kmers: Iterable[int]) -> None:
        self.rev = self[::-1]
        self._idx_map = {kmer: idx for idx, kmer in enumerate(self)}
        self.is_dup = len(self._idx_map) < len(self)
        self.warning: set[int] = set()

    def which_strand(self, kmers) -> str:
        """'+' same order, '-' reversed, 'u' single shared k-mer, '?' unknown."""
        idx_map = self._idx_map
        if kmers == self:
            return '+'
        if kmers == self.rev:
            return '-'
        if len(kmers) == 1:
            if kmers[0] in idx_map:
                return 'u'
            self.warning.add(1)
            return '?'
        if not self.is_dup:
            all_idx = [idx_map[k] for k in kmers if k in idx_map]
            if len(all_idx) == 1:
                self.warning.add(2)
                return 'u'
            if len(all_idx) == 0:
                self.warning.add(3)
                return '?'
            if all_idx == sorted(all_idx):
                return '+'
            if all_idx == sorted(all_idx, reverse=True):
                return '-'
            self.warning.add(4)
            return '?'
        kmers_shared = tuple(k for k in kmers if k in idx_map)
        n_shared = len(kmers_shared)
        if n_shared == 1:
            self.warning.add(5)
            return 'u'
        if n_shared == 0:
            self.warning.add(6)
            return '?'

        def check_order(ordered) -> bool:
            i = 0
            for kmer in ordered:
                if kmer == kmers_shared[i]:
                    i += 1
                    if i == n_shared:
                        return True
            return False

        if check_order(self):
            return '+'
        if check_order(self.rev):
            return '-'
        self.warning.add(7)
        return '?'
