"""Upstream Seqwin's greedy search for low-penalty subgraphs.

The graph is an insertion-ordered adjacency (networkx's order): edges are
added in (first, second) order, each adding ``first`` then ``second`` as a
node. Seeds are the nodes with penalty <= threshold in ascending id order,
shuffled by the run's `random.Random`. From each seed not yet used, the
search pops the least (penalty, id) of its frontier and takes the node while
the mean penalty stays <= threshold, up to ``max_nodes``; a subgraph of at
least ``min_nodes`` is kept and its nodes become used. The kept subgraphs
are shuffled again. Sets are built in the same insertion order as
upstream's, so their iteration orders, which the markers observe, agree.
"""
from __future__ import annotations

from heapq import heappop, heappush
from random import Random

import numpy as np


def adjacency(edges: np.ndarray) -> dict[int, dict[int, None]]:
    adj: dict[int, dict[int, None]] = {}
    for u, v in zip(edges['first'].tolist(), edges['second'].tolist()):
        adj.setdefault(u, {})
        adj.setdefault(v, {})
        adj[u][v] = None
        adj[v][u] = None
    return adj


def search(adj: dict, penalty: dict[int, float], th: float, min_nodes: int,
           max_nodes: int | None, rng: Random) -> tuple[list[frozenset], set]:
    seeds = [n for n, p in penalty.items() if p <= th]
    rng.shuffle(seeds)
    used: set[int] = set()
    found: list[set[int]] = []
    for s in seeds:
        if s in used:
            continue
        sg = {s}
        total = penalty[s]
        heap: list[tuple[float, int]] = []
        frontier: set[int] = set()
        for nbr in adj[s]:
            if nbr not in used and nbr not in sg:
                heappush(heap, (penalty[nbr], nbr))
                frontier.add(nbr)
        while heap and (max_nodes is None or len(sg) < max_nodes):
            p, node = heappop(heap)
            if node not in frontier:
                continue
            if (total + p) / (len(sg) + 1) <= th:
                sg.add(node)
                total += p
                for nbr in adj[node]:
                    if nbr not in used and nbr not in sg and nbr not in frontier:
                        heappush(heap, (penalty[nbr], nbr))
                        frontier.add(nbr)
            frontier.remove(node)
        if len(sg) >= min_nodes:
            found.append(sg)
            used |= sg
    rng.shuffle(found)
    return [frozenset(sg) for sg in found], used
