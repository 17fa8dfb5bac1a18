"""seqwin_tpu_torch's long records and low-memory build on the CPU against
the JAX package: records longer than the chunk budget are scanned in
halo'd blocks with an emission carry, and every output array (junction
edges included) equals the JAX package's host build
(`seqwin_tpu.graph.build(..., backend='numpy')`). The block plan equals
the JAX package's, and the junction edges its bridge pairs
(`aggregate_device(extra_pairs=...)`)."""
import importlib

import numpy as np
import pytest

from seqwin_tpu.engine import aggregate as jagg
from seqwin_tpu.engine import hybrid as jhybrid
from seqwin_tpu.graph import build as jax_build
from seqwin_tpu.graph.build import build_deferred as jax_build_deferred
from seqwin_tpu_torch.engine import hybrid
from seqwin_tpu_torch.engine.aggregate import aggregate_device
from seqwin_tpu_torch.graph import build, build_deferred

build_mod = importlib.import_module('seqwin_tpu_torch.graph.build')


def _rand_genome(rng, L, n_frac=0.0, n_runs=0):
    alphabet = np.array(list('ACGT'))
    seq = rng.choice(alphabet, L)
    if n_frac:
        idx = rng.integers(0, L, size=int(L * n_frac))
        seq[idx] = 'N'
    for _ in range(n_runs):
        s = int(rng.integers(0, max(1, L - 500)))
        seq[s:s + int(rng.integers(50, 500))] = 'N'
    return ''.join(seq)


def _assert_equal(got, ref):
    for a, b in zip(got[:4], ref[:4]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert list(got[4]) == list(ref[4])


def _write(tmp_path, name, records):
    p = tmp_path / name
    p.write_text(''.join(f'>r{i}\n{s}\n' for i, s in enumerate(records)))
    return p


def _check(paths, k, w, targets, monkeypatch, budget, low_memory):
    """The port's build with records above ``budget`` (the default chunk
    budget, or the low-memory one) against the JAX package's host build."""
    if low_memory:
        monkeypatch.setattr(build_mod, 'LOW_MEMORY_CHUNK_BASES', budget)
    else:
        monkeypatch.setattr(build_mod, 'DEFAULT_CHUNK_BASES', budget)
    got = build(paths, k, w, targets, low_memory=low_memory, device='cpu')
    ref = jax_build(paths, k, w, targets, backend='numpy')
    _assert_equal(got, ref)
    return got


# the four JAX tests of tests/test_long_records.py, on the default budget
# and, scaled the same way, on the low-memory budget


@pytest.mark.parametrize('low_memory', [False, True])
@pytest.mark.parametrize('k,w', [(17, 10), (7, 32), (11, 1)])
def test_long_record_blocks_match_jax(tmp_path, monkeypatch, k, w, low_memory):
    rng = np.random.default_rng(7)
    paths = [
        _write(tmp_path, 'jumbo.fasta', [_rand_genome(rng, 120_000, n_runs=3)]),
        _write(tmp_path, 'small.fasta', [_rand_genome(rng, 5_000), _rand_genome(rng, 3_000)]),
    ]
    _check(paths, k, w, [True, False], monkeypatch, 1 << 14, low_memory)


@pytest.mark.parametrize('low_memory', [False, True])
def test_long_record_n_desert_at_boundary(tmp_path, monkeypatch, low_memory):
    """An N desert wider than a block: a block keeps nothing, and the carry
    and the junction edge reach across it."""
    rng = np.random.default_rng(8)
    left = _rand_genome(rng, 9_000)
    right = _rand_genome(rng, 9_000)
    seq = left + 'N' * 20_000 + right  # desert spans multiple block budgets
    p = _write(tmp_path, 'desert.fasta', [seq])
    q = _write(tmp_path, 'other.fasta', [_rand_genome(rng, 4_000)])
    _check([p, q], 17, 10, [True, False], monkeypatch, 1 << 13, low_memory)


@pytest.mark.parametrize('low_memory', [False, True])
def test_long_record_shared_hashes_across_assemblies(tmp_path, monkeypatch, low_memory):
    """Mutated clones of one long genome: node n_tar/n_neg dedup and edge
    weights count each assembly once even when a record spans blocks."""
    rng = np.random.default_rng(9)
    alphabet = np.array(list('ACGT'))
    base = rng.choice(alphabet, 60_000)
    paths, targets = [], []
    for i in range(3):
        g = base.copy()
        idx = rng.integers(0, len(g), size=len(g) // 300)
        g[idx] = alphabet[(np.searchsorted(alphabet, g[idx]) + 1) % 4]
        paths.append(_write(tmp_path, f'clone{i}.fasta', [''.join(g)]))
        targets.append(i < 2)
    got = _check(paths, 17, 10, targets, monkeypatch, 1 << 14, low_memory)
    assert int((got[1]['n_tar'] == 2).sum()) > 100


@pytest.mark.parametrize('low_memory', [False, True])
@pytest.mark.parametrize('seed', range(3))
def test_long_record_fuzz(tmp_path, monkeypatch, seed, low_memory):
    rng = np.random.default_rng(40 + seed)
    k = int(rng.integers(3, 28))
    w = int(rng.integers(1, 48))
    paths, targets = [], []
    for i in range(2):
        recs = [_rand_genome(rng, int(rng.integers(20_000, 60_000)), n_frac=0.01, n_runs=2)]
        if i == 1:
            recs.append(_rand_genome(rng, 2_000))
        paths.append(_write(tmp_path, f'f{seed}_{i}.fasta', recs))
        targets.append(i == 0)
    _check(paths, k, w, targets, monkeypatch, 1 << 13, low_memory)


def test_low_memory_deferred_matches_jax(tmp_path, monkeypatch):
    """`build_deferred(low_memory=True)`: the device graph of a build with
    long records and several chunks equals the JAX package's deferred host
    build, and counts one phase-1 scan per block and per chunk."""
    rng = np.random.default_rng(11)
    paths = [_write(tmp_path, f'g{i}.fasta', [_rand_genome(rng, n, n_runs=2) for n in sizes])
             for i, sizes in enumerate([(30_000,), (3_000, 4_000, 5_000), (12_000, 2_000)])]
    targets = [True, False, True]
    budget = 8_000
    monkeypatch.setattr(build_mod, 'LOW_MEMORY_CHUNK_BASES', budget)
    g, offsets, ids = build_deferred(paths, 15, 20, targets, low_memory=True, device='cpu')
    jg, j_offsets, j_ids = jax_build_deferred(paths, 15, 20, targets, backend='numpy')
    np.testing.assert_array_equal(offsets, j_offsets)
    assert ids == j_ids
    np.testing.assert_array_equal(g.nodes, jg.nodes)
    for a, b in zip(g.materialize(), jg.materialize()):
        np.testing.assert_array_equal(a, b)
    # blocks of the 30k and 12k records; chunks [3k, 4k], [5k], [2k]
    scans, bases = 0, 0
    for c in _parsed(paths):
        if len(c) > budget:
            scans += (bases > 0) + len(hybrid._record_block_plan(c, 15, 20, budget))
            bases = 0
            continue
        if bases + len(c) > budget and bases:
            scans, bases = scans + 1, 0
        bases += len(c)
    assert g.n_chunks == scans + (bases > 0) == 3 + 4 + 2


def _parsed(paths):
    from seqwin_tpu_torch.io.fasta import parse_fasta_codes

    return [c for p in paths for c in parse_fasta_codes(str(p))[1]]


def _record_with_n_runs(rng, n, n_frac, runs):
    c = rng.integers(0, 4, size=n).astype(np.uint8)
    c[rng.random(n) < n_frac] = 255
    for _ in range(runs):
        s = int(rng.integers(0, n - 1))
        c[s:s + int(rng.integers(1, 3000))] = 255
    return c


@pytest.mark.parametrize('seed', range(4))
def test_record_block_plan_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    codes = _record_with_n_runs(rng, int(rng.integers(5_000, 80_000)), 0.01, 4)
    k = int(rng.integers(3, 32))
    w = int(rng.integers(1, 64))
    n_head = int(rng.integers(1, 2 * k))
    edged = codes.copy()
    edged[:n_head] = 255  # N runs at both ends of the record
    edged[-n_head:] = 255
    for c in (codes, edged):
        for budget in (1 << 10, 3_000, 1 << 13, 1 << 20):
            assert (hybrid._record_block_plan(c, k, w, budget)
                    == jhybrid._record_block_plan(c, k, w, budget))
    # degenerate: too few valid k-mers, no k-mer at all, all N
    for c in (codes[:k + w - 1], codes[:k - 1], np.full(5_000, 255, np.uint8)):
        assert hybrid._record_block_plan(c, k, w, 64) == jhybrid._record_block_plan(c, k, w, 64)


@pytest.mark.parametrize('case', ['random', 'n_desert'])
def test_junction_edges_match_jax_bridges(case):
    """One record in blocks: the port's concatenated exact-length streams
    give the edges the JAX package gets from its streams plus the bridge
    pairs (`aggregate_device(extra_pairs=...)`), and the block junctions
    the port's stream pairs up are exactly those bridges."""
    from seqwin_tpu_torch.ops import u64

    rng = np.random.default_rng(21)
    k, w, budget = 11, 16, 1 << 13
    if case == 'random':
        codes = _record_with_n_runs(rng, 40_000, 0.005, 3)
    else:
        codes = np.concatenate([rng.integers(0, 4, size=9_000), np.full(20_000, 255),
                                rng.integers(0, 4, size=9_000)]).astype(np.uint8)
    offsets = np.array([0, 1], dtype=np.uintp)
    target = np.array([True])
    res = hybrid.scan_record_blocks(codes, k, w, 0, budget, record_offsets=offsets, device='cpu')
    got = aggregate_device(res, target)
    j_res, pairs = jhybrid.scan_record_blocks(codes, k, w, 0, budget, min_chunk=budget,
                                              record_offsets=offsets)
    want = jagg.aggregate_device(j_res, offsets, target, extra_pairs=pairs)
    assert len(res) == len(hybrid._record_block_plan(codes, k, w, budget)) > 2
    if case == 'n_desert':
        assert any(r[3] == 0 for r in res)  # a block that keeps nothing
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    kept = [u64.to_numpy(r[0]) for r in res if r[3]]
    junctions = {(min(int(a[-1]), int(b[0])), max(int(a[-1]), int(b[0])), 0)
                 for a, b in zip(kept[:-1], kept[1:])}
    assert junctions == {tuple(int(x) for x in p) for p in pairs} and junctions
    edges = {(int(e['first']), int(e['second'])) for e in got[2]}
    assert {(u, v) for u, v, _ in junctions} <= edges
