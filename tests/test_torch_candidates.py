"""seqwin_tpu_torch's candidate markers, built for every subgraph in one
pass (`pipeline/markers._get_candidates`), against the JAX package's
`ConnectedKmers`, built subgraph by subgraph from its own arguments, slot
for slot: on random k-mer graphs and on crafted subgraphs that pin each
tie-break and warning; and with every fingerprint forced equal, so that
each subgraph is decided by the exact fallback."""
from dataclasses import astuple
from random import Random
from types import SimpleNamespace

import numpy as np
import pytest

import seqwin_tpu.pipeline.markers as jax_markers
import seqwin_tpu_torch.pipeline.markers as markers
from seqwin_tpu.graph.hashgraph import HashGraph as JaxHashGraph
from seqwin_tpu_torch.graph.dtypes import KMER_DTYPE, NODE_DTYPE
from seqwin_tpu_torch.graph.hashgraph import HashGraph

BIG = 2 ** 63  # hashes from here up compare as unsigned


def _path(p):
    return None if p is None else (tuple(p), tuple(p.rev), p.is_dup, p.warning)


def _rep(loc):
    return [(type(v), v) for v in astuple(loc)]


def _slots(ck):
    """Every slot of a candidate, with the types of the representative's
    fields."""
    return (_path(ck.path), _rep(ck.rep), ck.len, type(ck.n_rep), ck.n_rep, ck.blast,
            astuple(ck.metrics), ck.rep_ratio, ck.warnings, ck.is_bad)


def _assert_match(kg, jax_kg, n_tar, k, w):
    got = markers._get_candidates(kg, n_tar, k, w)
    want = [jax_markers.ConnectedKmers(*args)
            for args in jax_markers._get_create_ck_args(jax_kg, n_tar, k, w)]
    assert len(got) == len(want) == len(kg.subgraphs)
    for i, (g, j) in enumerate(zip(got, want)):
        assert _slots(g) == _slots(j), i
    return want


@pytest.fixture
def no_fingerprints(monkeypatch):
    """Every order's fingerprint 0: each group of equal lengths holds
    distinct orders, so the element check finds them all."""
    def zero(h, first, stop):
        z = np.zeros(len(first), dtype=np.uint64)
        return z, z

    monkeypatch.setattr(markers, '_fingerprints', zero)


# --- random k-mer graphs, both packages' `KmerGraph` built on the host ---

def _genomes(tmp, seed, n, n_records, length, snp):
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b'ACGT', dtype=np.uint8)
    base = rng.integers(0, 4, size=length).astype(np.uint8)
    paths = []
    for i in range(n):
        gseq = base.copy()
        idx = rng.integers(0, length, size=int(length * snp))
        gseq[idx] = (gseq[idx] + rng.integers(1, 4, size=idx.size)) % 4
        if i % 2:  # an inversion: orders read in reverse in some assemblies
            a = int(rng.integers(0, length // 2))
            gseq[a:a + length // 4] = 3 - gseq[a:a + length // 4][::-1]
        cuts = np.sort(rng.choice(np.arange(1, length), n_records - 1, replace=False))
        p = tmp / f's{seed}_{i}.fasta'
        p.write_text(''.join(f'>g{i}_{j}\n' + alphabet[r].tobytes().decode() + '\n'
                             for j, r in enumerate(np.split(gseq, cuts))))
        paths.append(p)
    return paths


def _kmer_graphs(tmp, seed, n_tar, n_neg, n_records, length, snp, k, w, max_nodes):
    from seqwin_tpu.assemblies import Assemblies as JaxAssemblies
    from seqwin_tpu.pipeline.kmers import KmerGraph as JaxKmerGraph
    from seqwin_tpu_torch.assemblies import Assemblies
    from seqwin_tpu_torch.pipeline.kmers import KmerGraph

    paths = _genomes(tmp, seed, n_tar + n_neg, n_records, length, snp)
    out = []
    for asm_cls, kg_cls in ((JaxAssemblies, JaxKmerGraph), (Assemblies, KmerGraph)):
        kg = kg_cls(asm_cls(paths[:n_tar], paths[n_tar:]), k, w, n_cpu=1, low_memory=False,
                    backend='numpy')
        kg.filter(penalty_th=0.5, edge_weight_th=1.0, min_nodes=2, max_nodes=max_nodes,
                  rng=Random(seed))
        out.append(kg)
    jax_kg, kg = out
    assert kg.subgraphs == jax_kg.subgraphs and len(kg.subgraphs) > 5
    return kg, jax_kg


# (seed, targets, non-targets, records, bases, SNP rate, k, w, max_nodes)
GRAPHS = [
    (5, 3, 3, 2, 20_000, 0.01, 17, 40, 50),
    (11, 4, 2, 3, 30_000, 0.02, 15, 20, 80),
    (12, 2, 4, 1, 25_000, 0.005, 21, 50, 30),
    (13, 6, 3, 4, 15_000, 0.03, 13, 10, None),
    (14, 5, 5, 2, 40_000, 0.01, 19, 30, 120),
    (15, 3, 1, 5, 12_000, 0.05, 11, 8, 60),
]


@pytest.mark.parametrize('params', GRAPHS, ids=[f'seed{p[0]}' for p in GRAPHS])
def test_candidates_match_jax_on_kmer_graphs(tmp_path, params):
    kg, jax_kg = _kmer_graphs(tmp_path, *params)
    _, n_tar, _, _, _, _, k, w, _ = params
    want = _assert_match(kg, jax_kg, n_tar, k, w)
    assert max(ck.rep.n_kmers for ck in want) > 2


@pytest.mark.parametrize('params', GRAPHS[:3], ids=[f'seed{p[0]}' for p in GRAPHS[:3]])
def test_candidates_match_jax_with_fingerprints_colliding(tmp_path, no_fingerprints, params):
    kg, jax_kg = _kmer_graphs(tmp_path, *params)
    _, n_tar, _, _, _, _, k, w, _ = params
    _assert_match(kg, jax_kg, n_tar, k, w)


# --- crafted subgraphs ---

def _crafted(subgraphs, records, n_tar):
    """Both packages' views of hand-made subgraphs. ``subgraphs``: per
    subgraph (its edges, {hash: [(pos, assembly, record), ...]}), the rows
    of each node in the order given; ``records``: records per assembly."""
    record_offsets = np.concatenate(([0], np.cumsum(records))).astype(np.uint32)
    node_rows = {}
    for _, rows in subgraphs:
        node_rows.update(rows)
    hashes = sorted(node_rows)
    kmers = np.zeros(sum(len(r) for r in node_rows.values()), dtype=KMER_DTYPE)
    nodes = np.zeros(len(hashes), dtype=NODE_DTYPE)
    off = 0
    for i, h in enumerate(hashes):
        rows = node_rows[h]
        nodes[i] = (h, off, off + len(rows), 0, 0, 0.0)
        for pos, asm, rec in rows:
            kmers[off] = (pos, record_offsets[asm] + rec)
            off += 1
    edges = sorted({tuple(sorted(e)) for es, _ in subgraphs for e in es})
    graph, jax_graph = HashGraph(), JaxHashGraph()
    graph.add_edges(edges)
    jax_graph.add_edges(edges)
    sgs = tuple(frozenset(rows) for _, rows in subgraphs)
    common = dict(kmers=kmers, nodes=nodes, record_offsets=record_offsets, subgraphs=sgs)
    return SimpleNamespace(graph=graph, **common), SimpleNamespace(graph=jax_graph, **common)


def _line(*hashes):
    return [(a, b) for a, b in zip(hashes, hashes[1:])]


def _run(asm, hashes, start=0, step=10, rec=0):
    """One assembly's rows reading ``hashes`` in order from ``start``."""
    return [(h, (start + i * step, asm, rec)) for i, h in enumerate(hashes)]


def _rows(*runs):
    out = {}
    for run in runs:
        for h, row in run:
            out.setdefault(h, []).append(row)
    return out


W = 10  # a gap above 1.5 * W = 15 splits a run

CRAFTED = {
    # assembly 0 holds two runs of two k-mers: the first is kept, both counted
    'equal_runs_first_wins': ([(_line(1, 2, 3, 4), _rows(
        _run(0, (1, 2)), _run(0, (3, 4), start=1000), _run(1, (3, 4)), _run(2, (1, 2))))],
        [1, 1, 1], 2),
    # a gap of exactly 1.5 w joins; one base more splits
    'gap_at_bound': ([(_line(1, 2, 3), _rows(_run(0, (1, 2, 3), step=15),
                                              _run(1, (1, 2, 3), step=15))),
                      (_line(4, 5, 6), _rows(_run(0, (4, 5, 6), step=16),
                                             _run(1, (4, 5), step=15), _run(1, (6,), start=200)))],
                     [1, 1], 2),
    # a run whose next k-mer is 2 bases on, in the next record
    'record_boundary': ([(_line(1, 2, 3, 4), _rows(
        _run(0, (1, 2), start=100), _run(0, (3, 4), start=112, rec=1),
        _run(1, (1, 2, 3, 4)), _run(2, (1, 2), start=50, rec=1)))],
        [2, 1, 2], 2),
    # one target reads (a, b, c), one (c, b, a): the canonical order wins,
    # which is (c, b, a) as hashes compare unsigned
    'orientation_tie': ([(_line(BIG + 1, 2, 3), _rows(
        _run(0, (BIG + 1, 2, 3)), _run(1, (3, 2, BIG + 1)), _run(2, (3, 2, BIG + 1))))],
        [1, 1, 1], 2),
    # the majority orientation against the canonical one
    'orientation_majority': ([(_line(7, 8, 9), _rows(
        _run(0, (7, 8, 9)), _run(1, (9, 8, 7)), _run(2, (9, 8, 7))))],
        [1, 1, 1], 3),
    # length x count ties (3 x 2 = 2 x 3): the order seen first wins, once
    # each way round
    'weighted_tie': ([(_line(10, 11, 12) + [(12, 20), (20, 21)], _rows(
        _run(0, (10, 11, 12)), _run(1, (20, 21)), _run(2, (21, 20)), _run(3, (12, 11, 10)),
        _run(4, (20, 21)))),
                      (_line(30, 31, 32) + [(32, 40), (40, 41)], _rows(
        _run(0, (40, 41)), _run(1, (30, 31, 32)), _run(2, (41, 40)), _run(3, (30, 31, 32)),
        _run(4, (40, 41))))],
                     [1] * 5, 5),
    # a longer order seen once outweighs a shorter one seen twice
    'weighted_length': ([(_line(1, 2, 3, 4, 5), _rows(
        _run(0, (1, 2)), _run(1, (1, 2)), _run(2, (1, 2, 3, 4, 5)), _run(3, (4, 5))))],
        [1] * 4, 4),
    # each target's longest run one k-mer long
    'single': ([(_line(1, 2), _rows(_run(0, (1,)), _run(0, (2,), start=500),
                                    _run(1, (2,)), _run(1, (1,), start=900)))], [1, 1], 2),
    # a k-mer twice in the order, which also reads the same reversed
    'dup_and_reversible': ([(_line(1, 2) + _line(2, 3), _rows(
        _run(0, (1, 2, 1)), _run(1, (1, 2, 1)), _run(2, (3, 2))))], [1, 1, 1], 2),
    # three leaves
    'non_linear': ([([(1, 2), (2, 3), (2, 4)], _rows(_run(0, (1, 2, 3)), _run(1, (1, 2, 4))))],
                   [1, 1], 2),
    # two paths between the leaves, the representative's among them, or not
    'multi_paths': ([([(0, 1), (1, 2), (2, 4), (1, 3), (3, 4), (4, 5)], _rows(
        _run(0, (0, 1, 3, 4, 5)), _run(1, (5, 4, 3, 1, 0)), _run(2, (0, 1, 2, 4, 5)))),
                     ([(10, 11), (11, 12), (12, 14), (11, 13), (13, 14), (14, 15)], _rows(
        _run(0, (10, 11, 13)), _run(1, (12, 14, 15))))],
                    [1, 1, 1], 2),
    # a linear graph whose path is not the representative's order
    'inconsistent': ([(_line(1, 2, 3, 4), _rows(_run(0, (1, 3, 2, 4)), _run(1, (4, 2, 3, 1))))],
                     [1, 1], 2),
    # a non-target holds the order twice, another splits it
    'non_target_repeats': ([(_line(1, 2, 3), _rows(
        _run(0, (3, 2, 1), start=40), _run(1, (1, 2, 3), start=70), _run(2, (1, 2, 3)),
        _run(2, (1, 2, 3), start=300), _run(3, (1, 2)), _run(3, (3,), start=100)))],
        [1, 1, 1, 1], 2),
}


@pytest.mark.parametrize('collide', [False, True], ids=['fingerprints', 'exact'])
@pytest.mark.parametrize('case', list(CRAFTED))
def test_candidates_match_jax_on_crafted_subgraphs(request, case, collide):
    if collide:
        request.getfixturevalue('no_fingerprints')
    subgraphs, records, n_tar = CRAFTED[case]
    kg, jax_kg = _crafted(subgraphs, records, n_tar)
    want = _assert_match(kg, jax_kg, n_tar, 5, W)
    expect = {'single': 'single', 'dup_and_reversible': 'dup', 'non_linear': 'non-linear',
              'multi_paths': 'multi-paths', 'inconsistent': 'inconsistent'}.get(case)
    if expect:
        assert any(expect in ck.warnings for ck in want)


def test_crafted_tie_breaks_hold():
    """What the crafted cases pin, read off the port's candidates."""
    def cands(case):
        subgraphs, records, n_tar = CRAFTED[case]
        return markers._get_candidates(_crafted(subgraphs, records, n_tar)[0], n_tar, 5, W)

    (ck,) = cands('equal_runs_first_wins')
    assert ck.rep.kmers == (1, 2) and ck.rep.assembly_idx == 0 and ck.rep.n_repeats == 2
    joined, split = cands('gap_at_bound')
    assert joined.rep.n_kmers == 3 and joined.rep.n_repeats == 1
    assert split.rep.n_kmers == 2 and split.rep.n_repeats == 2
    (ck,) = cands('record_boundary')
    assert ck.rep.assembly_idx == 1 and ck.n_rep == 1
    (ck,) = cands('orientation_tie')
    assert ck.rep.kmers == (3, 2, BIG + 1) and ck.rep.assembly_idx == 1
    (ck,) = cands('orientation_majority')
    assert ck.rep.kmers == (9, 8, 7) and ck.rep.assembly_idx == 1 and ck.n_rep == 3
    first, second = cands('weighted_tie')
    assert first.rep.kmers == (10, 11, 12) and first.n_rep == 2
    assert second.rep.kmers == (40, 41) and second.n_rep == 3
    (ck,) = cands('weighted_length')
    assert ck.rep.kmers == (1, 2, 3, 4, 5) and ck.rep.assembly_idx == 2 and ck.n_rep == 1
