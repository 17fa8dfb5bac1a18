"""Greedy low-penalty subgraph extraction.

Counterpart: `seqwin_tpu/pipeline/subgraphs.py` (a copy). Exact semantics
of the reference's greedy search, without networkx:

- seeds = nodes with penalty <= threshold, in ascending hash order, shuffled
  by the run RNG;
- each seed expands greedily via a min-heap frontier of (penalty, node),
  accepting a node iff the running average penalty stays <= threshold;
- a subgraph is kept iff it reaches ``min_nodes``; kept subgraphs are
  shuffled again before return.

Determinism notes (these define the output bytes):
- heap pops are totally ordered by (penalty, node-hash) -- insertion order is
  irrelevant because the frontier set prevents duplicates;
- subgraph *sets* are built with the same insertion sequence as the reference
  ({seed}, then accepted nodes in acceptance order), so Python set/frozenset
  iteration orders -- which downstream marker code observes via
  ``tuple(subgraph)`` -- are reproduced;
- the RNG is a stdlib ``random.Random`` shared with the reference contract.
"""
from __future__ import annotations

import logging
from heapq import heappop, heappush
from random import Random

from ..graph.hashgraph import HashGraph
from ..utils import fail

logger = logging.getLogger(__name__)


def get_subgraphs(
    graph: HashGraph,
    node_penalty: dict[int, float],
    penalty_th: float,
    min_nodes: int,
    max_nodes: int | None,
    rng: Random,
) -> tuple[tuple[frozenset, ...], frozenset]:
    """Find disjoint subgraphs with average node penalty <= penalty_th.

    Args:
        graph: adjacency over node hashes (ints).
        node_penalty: hash -> penalty, keys in ascending hash order.
        penalty_th, min_nodes, max_nodes: thresholds (see Config).
        rng: run RNG.

    Returns:
        (subgraphs, used): tuple of frozensets of node hashes, and their union.
    """
    seeds = [n for n, p in node_penalty.items() if p <= penalty_th]
    rng.shuffle(seeds)
    logger.info(f' - Expanding subgraphs from {len(seeds)} seed nodes (penalty<={penalty_th:.5f})...')

    used: set[int] = set()
    subgraphs: list[set[int]] = []

    for s in seeds:
        if s in used:
            continue
        sg = {s}
        sum_penalty = node_penalty[s]

        frontier_heap: list[tuple[float, int]] = []
        frontier_set: set[int] = set()
        for nbr in graph.neighbors(s):
            if (nbr not in used) and (nbr not in sg):
                heappush(frontier_heap, (node_penalty[nbr], nbr))
                frontier_set.add(nbr)

        while frontier_heap and ((max_nodes is None) or (len(sg) < max_nodes)):
            penalty, node = heappop(frontier_heap)
            if node not in frontier_set:
                continue
            new_sum_penalty = sum_penalty + penalty
            if new_sum_penalty / (len(sg) + 1) <= penalty_th:
                sg.add(node)
                sum_penalty = new_sum_penalty
                for nbr in graph.neighbors(node):
                    if (nbr not in used) and (nbr not in sg) and (nbr not in frontier_set):
                        heappush(frontier_heap, (node_penalty[nbr], nbr))
                        frontier_set.add(nbr)
            frontier_set.remove(node)

        if len(sg) >= min_nodes:
            subgraphs.append(sg)
            used |= sg

    if subgraphs:
        logger.info(f' - Found {len(subgraphs)} low-penalty subgraphs')
    else:
        fail(
            RuntimeError,
            ('No low-penalty subgraph was found. '
             'Try decrease --stringency, or increase --penalty-th (penalty threshold, check log for the calculated value)'),
        )

    rng.shuffle(subgraphs)
    return tuple(frozenset(sg) for sg in subgraphs), frozenset(used)
