"""seqwin_tpu_torch's host-only backends (`ops/host_build.py`,
`ops/oracle.py`, ``backend='numpy'|'oracle'``) and the sort engine
(`engine/minimizer.py`, ``SEQWIN_TPU_TORCH_SCAN=sort``) on the CPU against
their JAX package counterparts, exact equality everywhere."""
import importlib

import numpy as np
import pytest

from seqwin_tpu.engine import minimizer as jmin
from seqwin_tpu.graph import build as jax_build
from seqwin_tpu.graph.build import build_deferred as jax_build_deferred
from seqwin_tpu.ops import hashing as jhashing
from seqwin_tpu.ops import host_build as jhost
from seqwin_tpu.ops import oracle as joracle
from seqwin_tpu_torch.engine import minimizer
from seqwin_tpu_torch.engine.aggregate import HostGraph
from seqwin_tpu_torch.graph import build, build_deferred
from seqwin_tpu_torch.ops import hashing, host_build, oracle


def _records(rng, sizes, n_frac=0.02, runs=True):
    out = []
    for n in sizes:
        c = rng.integers(0, 4, size=n).astype(np.uint8)
        c[rng.random(n) < n_frac] = 255
        if runs and n > 300:
            s = int(rng.integers(0, n - 200))
            c[s:s + int(rng.integers(1, 200))] = 255
        out.append(c)
    return out


def _assert_graph_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_srol1_matches_jax():
    rng = np.random.default_rng(0)
    xs = [0, 1, (1 << 64) - 1, 1 << 63, 1 << 32, 1 << 33] + [
        int(x) for x in rng.integers(0, 1 << 63, size=200, dtype=np.uint64) * 2 + 1]
    for x in xs:
        assert hashing.srol1(x) == jhashing.srol1(x)
        # one split rotation is srol by 1
        assert hashing.srol1(x) == hashing.srol(x, 1)


@pytest.mark.parametrize('k,w', [(3, 1), (5, 4), (11, 16), (21, 50)])
def test_minimize_record_matches_jax(k, w):
    rng = np.random.default_rng(k * 100 + w)
    for codes in _records(rng, [0, k - 1, k + w - 2, 700, 5_000]):
        for a, b in zip(host_build.minimize_record(codes, k, w), jhost.minimize_record(codes, k, w)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('k,w', [(5, 4), (15, 20), (21, 50)])
def test_build_graph_vec_matches_jax(k, w):
    rng = np.random.default_rng(w)
    base = _records(rng, [4_000, 2_500], n_frac=0.0, runs=False)
    seqs = []
    for a in range(5):
        recs = [c.copy() for c in base]
        for c in recs:
            idx = rng.integers(0, len(c), size=40)
            c[idx] = (c[idx] + 1) % 4
            c[rng.random(len(c)) < 0.005] = 255
        if a == 2:
            recs.insert(1, np.zeros(0, np.uint8))
        seqs.append(recs)
    targets = [True, True, False, False, True]
    got = host_build.build_graph_vec(seqs, k, w, targets)
    want = jhost.build_graph_vec(seqs, k, w, targets)
    _assert_graph_equal(got, want)
    assert len(got[0]) > 100 and (got[2]['weight'] > 1).any()
    empty = host_build.build_graph_vec([[np.zeros(3, np.uint8)]], k, w, [True])
    _assert_graph_equal(empty, jhost.build_graph_vec([[np.zeros(3, np.uint8)]], k, w, [True]))


@pytest.mark.parametrize('k,w', [(3, 2), (7, 5)])
def test_oracle_matches_jax(k, w):
    rng = np.random.default_rng(k + w)
    codes = _records(rng, [600])[0]
    for a, b in zip(oracle.kmer_hashes(codes, k), joracle.kmer_hashes(codes, k)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for name in ('minimize', 'minimize_btllib_style'):
        got = getattr(oracle, name)(codes, k, w)
        assert got == getattr(joracle, name)(codes, k, w) and got
    seqs = [_records(rng, [500, 300]), _records(rng, [0, 400]), _records(rng, [700])]
    targets = [True, False, True]
    got = oracle.build_graph(seqs, k, w, targets)
    _assert_graph_equal(got, joracle.build_graph(seqs, k, w, targets))
    _assert_graph_equal(got, host_build.build_graph_vec(seqs, k, w, targets))
    np.testing.assert_array_equal(oracle.encode('ACGTNacgu'), joracle.encode('ACGTNacgu'))


@pytest.mark.parametrize('k,w', [(1, 1), (5, 3), (9, 12), (21, 30)])
def test_scan_records_host_matches_jax(k, w):
    """The sort engine on CPU torch (uint64 order through the sign-flipped
    key) against the JAX sort engine, empty and short records included."""
    rng = np.random.default_rng(3 * k + w)
    records = _records(rng, [1_500, 0, 40, 3, 2_000, 0, k + w - 1, 900])
    got = minimizer.scan_records_host(records, k, w, device='cpu')
    want = jmin.scan_records_host(records, k, w, min_chunk=1 << 14)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(got[0]) > 50
    # the stream's own hashes: the host builder's per-record minimizers
    for r, codes in enumerate(records):
        oh, pos = host_build.minimize_record(codes, k, w)
        np.testing.assert_array_equal(got[0][got[2] == r], oh)
        np.testing.assert_array_equal(got[1][got[2] == r], pos)


def test_scan_records_host_empty():
    got = minimizer.scan_records_host([np.zeros(0, np.uint8)] * 3, 5, 3, device='cpu')
    want = jmin.scan_records_host([np.zeros(0, np.uint8)] * 3, 5, 3)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and len(a) == len(b) == 0


@pytest.fixture(scope='module')
def fastas(tmp_path_factory):
    """4 related assemblies: multi-record, N runs, one empty record."""
    tmp = tmp_path_factory.mktemp('host_fastas')
    rng = np.random.default_rng(12)
    base = rng.integers(0, 4, size=9_000).astype(np.uint8)
    alphabet = np.frombuffer(b'ACGTN', np.uint8)
    paths = []
    for i in range(4):
        g = base.copy()
        idx = rng.integers(0, len(g), size=60)
        g[idx] = (g[idx] + 1) % 4
        g[2000 + 40 * i:2060 + 40 * i] = 4
        parts = np.split(g, np.sort(rng.integers(0, len(g), size=1 + i % 2)))
        text = ''.join(f'>a{i}_r{j}\n{alphabet[p].tobytes().decode()}\n' for j, p in enumerate(parts))
        if i == 1:
            text += '>empty\n'
        paths.append(tmp / f'g{i}.fa')
        paths[-1].write_text(text)
    return paths, [True, True, False, False]


@pytest.mark.parametrize('backend', ['numpy', 'oracle'])
def test_build_host_backend_matches_jax(fastas, backend):
    """`build(backend=...)` needs no device: it runs with ``device=None``
    (the GPU) on a machine without one."""
    paths, targets = fastas
    k, w = (13, 10) if backend == 'numpy' else (7, 6)
    got = build(paths, k, w, targets, backend=backend)
    want = jax_build(paths, k, w, targets, backend=backend)
    _assert_graph_equal(got[:4], want[:4])
    assert got[4] == want[4]
    g, offsets, ids = build_deferred(paths, k, w, targets, backend=backend)
    jg, j_offsets, j_ids = jax_build_deferred(paths, k, w, targets, backend=backend)
    assert isinstance(g, HostGraph) and ids == j_ids
    np.testing.assert_array_equal(offsets, j_offsets)
    np.testing.assert_array_equal(g.nodes, jg.nodes)
    _assert_graph_equal(g.materialize(), jg.materialize())
    assert (g.n_kmers, g.n_edges) == (jg.n_kmers, jg.n_edges)


@pytest.mark.parametrize('budget', [None, 6000])
def test_sort_engine_build_matches_jax(fastas, monkeypatch, budget):
    """``SEQWIN_TPU_TORCH_SCAN=sort``: one chunk, and chunks smaller than
    the longest record (which the sort engine scans whole)."""
    paths, targets = fastas
    monkeypatch.setenv('SEQWIN_TPU_TORCH_SCAN', 'sort')
    if budget:
        monkeypatch.setattr(importlib.import_module('seqwin_tpu_torch.graph.build'),
                            'DEFAULT_CHUNK_BASES', budget)
    got = build(paths, 13, 10, targets, device='cpu')
    want = jax_build(paths, 13, 10, targets, backend='numpy')
    _assert_graph_equal(got[:4], want[:4])
    assert got[4] == want[4]
    g, *_ = build_deferred(paths, 13, 10, targets, device='cpu')
    assert (g.n_chunks > 1) == bool(budget)


def test_host_backend_takes_no_device(fastas, monkeypatch):
    """The host build never asks for a device; the device build does."""
    def no_device(*args):
        raise AssertionError('a device was requested')

    monkeypatch.setattr(importlib.import_module('seqwin_tpu_torch.graph.build'),
                        'resolve_device', no_device)
    paths, targets = fastas
    for backend in ('numpy', 'oracle'):
        got = build(paths[:2], 7, 6, targets[:2], backend=backend)
        assert len(got[0]) > 100
    with pytest.raises(AssertionError, match='device was requested'):
        build(paths[:2], 7, 6, targets[:2])
