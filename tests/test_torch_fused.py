"""seqwin_tpu_torch's fused one-program build (``SEQWIN_TPU_TORCH_FUSED=1``,
`engine/fused.py`) on the CPU against the JAX package's fused build
(``SEQWIN_TPU_FUSED=1``), its oversized-record fallback, several launch
groups and empty records; all exact."""
import importlib

import numpy as np
import pytest

from seqwin_tpu.graph.build import build as jax_build
from seqwin_tpu.graph.build import build_deferred as jax_build_deferred
from seqwin_tpu_torch.engine import fused
from seqwin_tpu_torch.graph.build import build, build_deferred

build_mod = importlib.import_module('seqwin_tpu_torch.graph.build')

K, W = 13, 30
BUDGET = 1 << 15


def _write(path, records):
    alpha = np.frombuffer(b'ACGTN', dtype=np.uint8)
    path.write_text(''.join(f'>{rid}\n' + alpha[g].tobytes().decode() + '\n' for rid, g in records))


@pytest.fixture(scope='module')
def genomes(tmp_path_factory):
    """The inputs of the JAX fused test (`tests/test_graph_build.py`): 4
    genomes of 20-60 kbp, 2% N, two records each, and one genome of one
    record above the 2^15 budget."""
    tmp = tmp_path_factory.mktemp('fused')
    rng = np.random.default_rng(11)
    paths, targets = [], []
    for i in range(4):
        n = int(rng.integers(20_000, 60_000))
        g = rng.integers(0, 4, size=n).astype(np.uint8)
        g[rng.random(n) < 0.02] = 4
        cut = n // 3
        p = tmp / f'g{i}.fasta'
        _write(p, [(f'r{i}a', g[:cut]), (f'r{i}b', g[cut:])])
        paths.append(p)
        targets.append(i < 2)
    big = tmp / 'big.fasta'
    _write(big, [('big', rng.integers(0, 4, size=BUDGET + 5000).astype(np.uint8))])
    return paths, targets, big


@pytest.fixture
def fused_env(monkeypatch):
    """Both packages' fused builds at the 2^15 budget."""
    monkeypatch.setattr(importlib.import_module('seqwin_tpu.graph.build'),
                        'DEFAULT_CHUNK_BASES', BUDGET)
    monkeypatch.setenv('SEQWIN_TPU_TORCH_CHUNK_BASES', str(BUDGET))
    monkeypatch.setenv('SEQWIN_TPU_FUSED', '1')
    monkeypatch.setenv('SEQWIN_TPU_TORCH_FUSED', '1')
    monkeypatch.setitem(build_mod.counters, 'fused_fallbacks', 0)


def _assert_build_equal(got, want):
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[4] == want[4]


@pytest.mark.parametrize('oversized', [False, True], ids=['fused', 'oversized_fallback'])
def test_fused_build_matches_jax_fused(genomes, fused_env, oversized):
    """`build` with the variable set against JAX `build` with its own; a
    record above the budget falls back to the per-chunk path in both."""
    paths, targets, big = genomes
    if oversized:
        paths, targets = [*paths, big], [*targets, True]
    got = build(paths, K, W, targets, device='cpu')
    want = jax_build(paths, K, W, targets)
    assert len(want[0]) > 1000
    _assert_build_equal(got, want)
    assert build_mod.counters['fused_fallbacks'] == int(oversized)


def test_fused_build_deferred_keep_codes_matches_jax(genomes, fused_env):
    """`build_deferred(keep_codes=True)`: the graph, the kept parse, and the
    number of B1 launches (one launch group here)."""
    paths, targets, _ = genomes
    graph, offsets, ids = build_deferred(paths, K, W, targets, keep_codes=True, device='cpu')
    jg, j_offsets, j_ids = jax_build_deferred(paths, K, W, targets, keep_codes=True)
    np.testing.assert_array_equal(offsets, j_offsets)
    assert ids == j_ids
    np.testing.assert_array_equal(graph.nodes, jg.nodes)
    for a, b in zip(graph.materialize(), jg.materialize()):
        np.testing.assert_array_equal(a, b)
    assert graph.n_chunks == 1
    for got_asm, want_asm in zip(graph.record_codes, jg.record_codes, strict=True):
        for a, b in zip(got_asm, want_asm, strict=True):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('limit', [BUDGET, 3 * BUDGET])
def test_fused_launch_groups_match_per_chunk(genomes, fused_env, monkeypatch, limit):
    """Launch groups of whole chunks below a (lowered) position limit: one
    B1 launch each, the same graph as the per-chunk build."""
    monkeypatch.setattr(fused, '_GROUP_LIMIT', limit)
    paths, targets, _ = genomes
    graph, *_ = build_deferred(paths, K, W, targets, device='cpu')
    monkeypatch.setenv('SEQWIN_TPU_TORCH_FUSED', '0')
    per_chunk, *_ = build_deferred(paths, K, W, targets, device='cpu')
    chunk_lists, _ = build_mod._group_chunks(
        [(None, build_mod.parse_fasta_codes(str(p))[1]) for p in paths], BUDGET)
    sizes = [sum(len(c) for c in recs) for recs, _ in chunk_lists]
    want_groups = fused._launch_groups(np.concatenate([[0], np.cumsum(sizes)]))
    assert graph.n_chunks == len(want_groups) > 1
    assert all(hi - lo <= limit for lo, hi in want_groups)
    np.testing.assert_array_equal(graph.nodes, per_chunk.nodes)
    for a, b in zip(graph.materialize(), per_chunk.materialize()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('lens', [
    [900, 0, 1200, 0, 0, 1500, 40, 0, 1400, 700, 0],
    [0, 0, 0, 0],
], ids=['mixed', 'all_empty'])
def test_fused_empty_records(tmp_path, monkeypatch, lens):
    """Empty records at the ends of chunks (where the next chunk starts at
    the same stream position), records shorter than k, N runs, and a
    dataset of empty records only: the fused build equals the JAX package's
    host build."""
    rng = np.random.default_rng(5)
    recs = []
    for i, n in enumerate(lens):
        g = rng.integers(0, 4, size=n).astype(np.uint8)
        if n > 500:
            g[100:160 + i] = 4
        recs.append((f'r{i}', g))
    paths = []
    for a, part in enumerate((recs[:3], recs[3:5], recs[5:9], recs[9:])):
        p = tmp_path / f'a{a}.fasta'
        _write(p, part)
        paths.append(p)
    targets = [True, False, True, False]
    monkeypatch.setenv('SEQWIN_TPU_TORCH_CHUNK_BASES', '1500')
    monkeypatch.setenv('SEQWIN_TPU_TORCH_FUSED', '1')
    monkeypatch.setitem(build_mod.counters, 'fused_fallbacks', 0)
    got = build(paths, 7, 10, targets, device='cpu')
    assert build_mod.counters['fused_fallbacks'] == 0
    _assert_build_equal(got, jax_build(paths, 7, 10, targets, backend='numpy'))
