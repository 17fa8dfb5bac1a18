"""seqwin_tpu_torch's `HashGraph.subgraph` with the parent's node ranks
against the same call without them, the JAX package's copy and networkx,
and the marker phase's per-subgraph arguments (each subgraph's slice of
`_gather_rows` and its cut graph) against the JAX package's
`_get_create_ck_args` on one small k-mer graph."""
import pickle
from random import Random

import numpy as np
import pytest

networkx = pytest.importorskip('networkx')

import seqwin_tpu.pipeline.markers as jax_markers
import seqwin_tpu_torch.pipeline.markers as markers
from seqwin_tpu.graph.hashgraph import HashGraph as JaxHashGraph
from seqwin_tpu_torch.graph.hashgraph import HashGraph

N_NODES, N_EDGES = 14, 22


def _random_edges(rng, n_nodes, n_edges):
    """Distinct (first <= second) pairs, self-loops among them, in sorted
    order as the k-mer graph adds them."""
    edges = set()
    while len(edges) < n_edges:
        u, v = sorted(int(x) for x in rng.integers(0, n_nodes, size=2))
        edges.add((u, v))
    return sorted(edges)


def _graphs(edges):
    g, jg, nx_g = HashGraph(), JaxHashGraph(), networkx.Graph()
    g.add_edges(edges)
    jg.add_edges(edges)
    nx_g.add_edges_from(edges)
    return g, jg, nx_g


def _items(g):
    """The adjacency as ordered lists, so that order is compared too."""
    return [(n, list(nbrs)) for n, nbrs in g._adj.items()]


def _subsets(rng, g):
    """Random node subsets of ``g`` with nodes it does not hold (ids from
    ``N_NODES`` up) and repeats, each in a shuffled order."""
    nodes = list(g)
    for size in (1, 3, len(nodes) // 2, len(nodes)):
        pick = [nodes[i] for i in rng.choice(len(nodes), size=size, replace=False)]
        extra = [int(x) for x in rng.integers(N_NODES, 2 * N_NODES, size=3)]
        bunch = pick + extra + pick[:2]
        rng.shuffle(bunch)
        yield bunch


@pytest.mark.parametrize('seed', range(12))
def test_ranked_subgraph_equals_unranked(seed):
    rng = np.random.default_rng(seed)
    g, jg, _ = _graphs(_random_edges(rng, N_NODES, N_EDGES))
    order = {n: i for i, n in enumerate(g)}
    for bunch in _subsets(rng, g):
        plain = g.subgraph(bunch)
        ranked = g.subgraph(bunch, order)
        # without ranks: what the JAX package's copy gives, unchanged
        assert _items(plain) == _items(jg.subgraph(bunch))
        assert _items(g.subgraph(iter(bunch))) == _items(plain)
        assert _items(ranked) == _items(plain)
        # a generator as the bunch, consumed once
        assert _items(g.subgraph(iter(bunch), order)) == _items(plain)
        # no state beyond the adjacency
        assert pickle.dumps(ranked) == pickle.dumps(plain)


@pytest.mark.parametrize('seed', range(12))
def test_ranked_subgraph_orders_match_networkx(seed):
    rng = np.random.default_rng(1000 + seed)
    g, _, nx_g = _graphs(_random_edges(rng, N_NODES, N_EDGES))
    order = {n: i for i, n in enumerate(g)}
    for bunch in _subsets(rng, g):
        sub = g.subgraph(bunch, order)
        keep = {n for n in bunch if n in nx_g}
        # networkx's induced subgraph view in the parent's node and
        # neighbour orders (`Graph.subgraph` walks a node set under half the
        # graph in the set's own order, and `copy()` re-adds the edges)
        nx_sub = networkx.subgraph_view(nx_g, filter_node=keep.__contains__)
        assert networkx.utils.graphs_equal(nx_sub, nx_g.subgraph(keep))
        assert list(sub) == list(nx_sub)
        for n in sub:
            assert list(sub.neighbors(n)) == list(nx_sub.neighbors(n))
            assert sub.degree(n) == nx_sub.degree[n]
        nodes = list(sub)
        for s in nodes[:4]:
            for t in nodes[-4:]:
                if s != t:
                    assert (list(sub.all_simple_paths(s, t))
                            == list(networkx.all_simple_paths(nx_sub, s, t))), (s, t)


def test_hashgraph_holds_the_adjacency_only():
    assert HashGraph.__slots__ == ('_adj',)


@pytest.fixture(scope='module')
def kmer_graphs(tmp_path_factory):
    """One set of six genomes (three targets) filtered into subgraphs by
    each package's `KmerGraph`, both built on the host."""
    from seqwin_tpu.assemblies import Assemblies as JaxAssemblies
    from seqwin_tpu.pipeline.kmers import KmerGraph as JaxKmerGraph
    from seqwin_tpu_torch.assemblies import Assemblies
    from seqwin_tpu_torch.pipeline.kmers import KmerGraph

    tmp = tmp_path_factory.mktemp('hashgraph')
    rng = np.random.default_rng(5)
    alphabet = np.frombuffer(b'ACGT', dtype=np.uint8)
    base = rng.integers(0, 4, size=20_000).astype(np.uint8)
    paths = []
    for i in range(6):
        gseq = base.copy()
        idx = rng.integers(0, len(gseq), size=len(gseq) // 100)
        gseq[idx] = (gseq[idx] + rng.integers(1, 4, size=idx.size)) % 4
        cut = len(gseq) // 3
        p = tmp / f'g{i}.fasta'
        p.write_text(f'>g{i}_0\n' + alphabet[gseq[:cut]].tobytes().decode() + '\n'
                     f'>g{i}_1\n' + alphabet[gseq[cut:]].tobytes().decode() + '\n')
        paths.append(p)
    out = []
    for asm_cls, kg_cls in ((JaxAssemblies, JaxKmerGraph), (Assemblies, KmerGraph)):
        kg = kg_cls(asm_cls(paths[:3], paths[3:]), 17, 40, n_cpu=1, low_memory=False,
                    backend='numpy')
        kg.filter(penalty_th=0.5, edge_weight_th=1.0, min_nodes=2, max_nodes=50, rng=Random(7))
        out.append(kg)
    return out


def test_create_ck_args_match_jax(kmer_graphs):
    jax_kg, kg = kmer_graphs
    assert kg.subgraphs == jax_kg.subgraphs and len(kg.subgraphs) > 10
    assert _items(kg.graph) == _items(jax_kg.graph)
    rows = markers._gather_rows(kg)
    order = {n: i for i, n in enumerate(kg.graph)}
    got = [(kg.graph.subgraph(sg, order), tuple(a[lo:hi] for a in rows[:4]))
           for sg, lo, hi in zip(kg.subgraphs, rows.offsets[:-1], rows.offsets[1:])]
    ref = list(jax_markers._get_create_ck_args(jax_kg, 3, 17, 40))
    assert len(got) == len(ref) == len(kg.subgraphs)
    assert rows.offsets[-1] == len(rows.pos) == len(kg.kmers)  # every kept row, once
    # subgraphs of more than a node pair, so order has something to decide
    assert max(len(a[0]) for a in got) > 2
    for (graph, rows), (jax_graph, jax_rows, *jax_rest) in zip(got, ref):
        assert _items(graph) == _items(jax_graph)
        assert len(rows) == len(jax_rows) == 4  # hashes, positions, assembly, record
        for a, b in zip(rows, jax_rows):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert jax_rest == [17, 40, 3]
