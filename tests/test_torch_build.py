"""seqwin_tpu_torch's graph build on the CPU against the JAX package's build
(numpy backend for the 5-tuple, the device path for the deferred graph)."""
import gzip
import importlib

import numpy as np
import pytest

from seqwin_tpu.graph.build import build as jax_build
from seqwin_tpu.graph.build import build_deferred as jax_build_deferred
from seqwin_tpu.graph.build import kept_node_layout
from seqwin_tpu_torch.graph.build import build, build_deferred
from seqwin_tpu_torch.io.fasta import parse_fasta_codes

build_mod = importlib.import_module('seqwin_tpu_torch.graph.build')

K, W = 21, 50


@pytest.fixture(scope='module')
def fastas(tmp_path_factory):
    """6 related assemblies: multi-record, N runs and scattered Ns, lowercase
    bases, one empty record, one short record, one gzip file."""
    tmp = tmp_path_factory.mktemp('fastas')
    rng = np.random.default_rng(0)
    base = rng.integers(0, 4, size=20000).astype(np.uint8)
    paths, targets = [], []
    for i in range(6):
        g = base.copy()
        idx = rng.integers(0, len(g), size=200)
        g[idx] = (g[idx] + 1) % 4
        s = np.frombuffer(b'ACGT', np.uint8)[g].copy()
        s[rng.integers(0, len(s), size=30)] = ord('N')
        s[5000 + 100 * i:5100 + 100 * i] = ord('N')
        s[12000:12400] = np.char.lower(s[12000:12400].view('S1')).view(np.uint8)
        parts = np.split(s, np.sort(rng.integers(0, len(s), size=1 + i % 3)))
        text = b''
        for j, p in enumerate(parts):
            text += f'>a{i}_r{j} description\n'.encode()
            text += b'\n'.join(p[o:o + 70].tobytes() for o in range(0, len(p), 70)) + b'\n'
        if i == 2:
            text += b'>empty\n'
        text += b'>short\nACGTACGTAC\n'
        if i == 4:
            path = tmp / f'g{i}.fa.gz'
            path.write_bytes(gzip.compress(text))
        else:
            path = tmp / f'g{i}.fa'
            path.write_bytes(text)
        paths.append(path)
        targets.append(i < 3)
    return paths, targets


@pytest.fixture(scope='module')
def reference(fastas):
    paths, targets = fastas
    return jax_build(paths, K, W, targets, backend='numpy')


def _assert_build_equal(got, want):
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[4] == want[4]


@pytest.mark.parametrize('budget', [None, 30000, 45000])
def test_build_matches_jax(fastas, reference, monkeypatch, budget):
    """Default budget (one chunk) and budgets that force several chunks."""
    if budget:
        monkeypatch.setattr(build_mod, 'DEFAULT_CHUNK_BASES', budget)
    paths, targets = fastas
    got = build(paths, K, W, targets, n_cpu=2, device='cpu')
    assert len(reference[0]) > 1000 and (reference[2]['weight'] > 1).any()
    _assert_build_equal(got, reference)


@pytest.mark.parametrize('n_cpu', [1, 4])
@pytest.mark.parametrize('overflow', [False, True], ids=['fits', 'every_chunk_overflows'])
def test_deferred_dispatch_matches_jax(fastas, reference, monkeypatch, n_cpu, overflow):
    """The deferred, threaded chunk dispatch with one and four prep threads,
    and with an emission capacity so small that every chunk overflows it
    and is scanned again exactly: byte-equal to the JAX package."""
    from seqwin_tpu_torch.engine import hybrid

    monkeypatch.setattr(build_mod, 'DEFAULT_CHUNK_BASES', 30000)
    monkeypatch.setitem(build_mod.counters, 'overflow_reruns', 0)
    if overflow:
        monkeypatch.setattr(hybrid, 'emit_capacity', lambda n, w: 8)
    paths, targets = fastas
    got = build(paths, K, W, targets, n_cpu=n_cpu, device='cpu')
    _assert_build_equal(got, reference)
    graph, *_ = build_deferred(paths, K, W, targets, n_cpu=n_cpu, device='cpu')
    np.testing.assert_array_equal(graph.nodes, reference[1])
    assert build_mod.counters['overflow_reruns'] == (2 * graph.n_chunks if overflow else 0)
    assert graph.n_chunks > 3


@pytest.fixture(scope='module')
def deferred(fastas):
    paths, targets = fastas
    got = build_deferred(paths, K, W, targets, device='cpu')
    want = jax_build_deferred(paths, K, W, targets)
    return got, want


def test_build_deferred_matches_jax(deferred, reference):
    (g, offsets, ids), (jg, j_offsets, j_ids) = deferred
    np.testing.assert_array_equal(offsets, j_offsets)
    assert ids == j_ids
    np.testing.assert_array_equal(g.nodes, jg.nodes)
    np.testing.assert_array_equal(g.nodes, reference[1])
    assert (g.n_kmers, g.n_edges) == (jg.n_kmers, jg.n_edges)
    for a, b in zip(g.materialize(), jg.materialize()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('th', [0.0, 1.0, 2.5, 4.0])
def test_deferred_filter_edges_matches_jax(deferred, th):
    (g, *_), (jg, *_) = deferred
    np.testing.assert_array_equal(g.filter_edges(th), jg.filter_edges(th))


@pytest.mark.parametrize('frac', [0.0, 0.05, 0.5])
def test_deferred_compact_kmers_matches_jax(deferred, frac):
    (g, *_), (jg, *_) = deferred
    rng = np.random.default_rng(int(frac * 100))
    used = rng.choice(g.nodes['hash'], size=int(g.n_nodes * frac), replace=False)
    keep, _, total = kept_node_layout(g.nodes, used)
    np.testing.assert_array_equal(g.compact_kmers(keep, total), jg.compact_kmers(keep, total))


@pytest.mark.parametrize('kwargs,env', [
    (dict(low_memory=True), {'LOW_MEMORY_CHUNK_BASES': 6000}),
    (dict(backend='numpy'), {}),
    (dict(backend='oracle'), {}),
    (dict(devices=2, low_memory=True), {'LOW_MEMORY_CHUNK_BASES': 1}),
    ({}, {'DEFAULT_CHUNK_BASES': 1000}),
], ids=['low_memory', 'numpy', 'oracle', 'devices_low_memory', 'long_records'])
def test_long_record_and_host_paths_match_jax(fastas, monkeypatch, kwargs, env):
    """Low memory (records above its budget in blocks), the host backends,
    multi-device low memory and records above a small chunk budget: each
    byte-equal to the JAX package's host build of the same FASTAs (the
    oracle on three of them: its Python loops are slow)."""
    for key, val in env.items():
        if key.startswith('SEQWIN'):
            monkeypatch.setenv(key, val)
        else:
            monkeypatch.setattr(build_mod, key, val)
    paths, targets = fastas
    if kwargs.get('backend') == 'oracle':
        paths, targets = paths[:3], targets[:3]
    got = build(paths, K, W, targets, device='cpu', **kwargs)
    _assert_build_equal(got, jax_build(paths, K, W, targets, backend='numpy'))


@pytest.mark.parametrize('budget', [None, 30000])
def test_build_deferred_counts_chunks(fastas, monkeypatch, budget):
    """``n_chunks`` follows the packing rule: records in scan order, a new
    chunk when the next record would pass the budget."""
    if budget:
        monkeypatch.setattr(build_mod, 'DEFAULT_CHUNK_BASES', budget)
    paths, targets = fastas
    lens = [len(c) for p in paths for c in parse_fasta_codes(str(p))[1]]
    want, bases = 1, 0
    for n in lens:
        if budget and bases + n > budget and bases:
            want, bases = want + 1, 0
        bases += n
    g, *_ = build_deferred(paths, K, W, targets, device='cpu')
    assert g.n_chunks == want
    assert (want > 1) == bool(budget)


@pytest.mark.parametrize('n_cpu', [1, 4])
@pytest.mark.parametrize('lens', [
    [900, 0, 1200, 0, 0, 1500, 40, 0, 1400, 700, 0],
    [0, 0, 0, 0],
], ids=['mixed', 'all_empty'])
def test_empty_records_match_jax(tmp_path, monkeypatch, lens, n_cpu):
    """Empty records at the ends of chunks (where the next chunk starts at
    the same stream position), records shorter than k, N runs, and a
    dataset of empty records only (every chunk's prep is empty): the
    per-chunk build at a 1,500-base budget equals the JAX package's host
    build."""
    rng = np.random.default_rng(5)
    alpha = np.frombuffer(b'ACGTN', dtype=np.uint8)
    recs = []
    for i, n in enumerate(lens):
        g = rng.integers(0, 4, size=n).astype(np.uint8)
        if n > 500:
            g[100:160 + i] = 4
        recs.append((f'r{i}', g))
    paths = []
    for a, part in enumerate((recs[:3], recs[3:5], recs[5:9], recs[9:])):
        p = tmp_path / f'a{a}.fasta'
        p.write_text(''.join(f'>{rid}\n' + alpha[g].tobytes().decode() + '\n' for rid, g in part))
        paths.append(p)
    targets = [True, False, True, False]
    monkeypatch.setattr(build_mod, 'DEFAULT_CHUNK_BASES', 1500)
    got = build(paths, 7, 10, targets, n_cpu=n_cpu, device='cpu')
    _assert_build_equal(got, jax_build(paths, 7, 10, targets, backend='numpy'))


@pytest.mark.parametrize('kwargs,env', [
    ({}, {}),
    ({}, {'DEFAULT_CHUNK_BASES': 1000}),
    (dict(low_memory=True), {'LOW_MEMORY_CHUNK_BASES': 6000}),
    ({}, {'SEQWIN_TPU_TORCH_SCAN': 'sort'}),
    (dict(backend='numpy'), {}),
    (dict(backend='oracle'), {}),
    (dict(devices=2), {}),
    (dict(devices=3, low_memory=True), {'LOW_MEMORY_CHUNK_BASES': 1}),
], ids=['chunks', 'long_records', 'low_memory', 'sort', 'numpy', 'oracle', 'devices',
        'devices_low_memory'])
def test_keep_codes_matches_jax(fastas, monkeypatch, kwargs, env):
    """``keep_codes`` on every build path: ``graph.record_codes`` holds the
    JAX package's parse, per assembly the list of its record codes, and the
    graph is the one built without it."""
    for key, val in env.items():
        if key.startswith('SEQWIN'):
            monkeypatch.setenv(key, val)
        else:
            monkeypatch.setattr(build_mod, key, val)
    paths, targets = fastas
    if kwargs.get('backend') == 'oracle':
        paths, targets = paths[:3], targets[:3]
    graph, offsets, ids = build_deferred(paths, K, W, targets, keep_codes=True, device='cpu',
                                         **kwargs)
    want = jax_build_deferred(paths, K, W, targets, backend='numpy', keep_codes=True)[0]
    assert len(graph.record_codes) == len(want.record_codes) == len(paths)
    for got_asm, want_asm in zip(graph.record_codes, want.record_codes):
        assert len(got_asm) == len(want_asm)
        for a, b in zip(got_asm, want_asm):
            assert a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(a, b)
    plain, *_ = build_deferred(paths, K, W, targets, device='cpu', **kwargs)
    assert plain.record_codes is None
    np.testing.assert_array_equal(graph.nodes, plain.nodes)
    graph.release()
    assert graph.record_codes is None
