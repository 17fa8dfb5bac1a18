"""seqwin_tpu_torch's aggregation against the JAX package's
`engine.aggregate` on the same minimizer stream: direct and deferred."""
import numpy as np
import pytest

import jax.numpy as jnp

from seqwin_tpu.engine import aggregate as jax_agg
from seqwin_tpu.graph.build import kept_node_layout
from seqwin_tpu_torch.engine import aggregate, hybrid
from seqwin_tpu_torch.ops import u64


@pytest.fixture(scope='module')
def stream():
    """Minimizer stream of 6 related assemblies (shared base, ~1% SNPs, N
    runs, 2-3 records each, one empty record), so hashes recur across
    assemblies and edges gather weights > 1."""
    rng = np.random.default_rng(0)
    k, w = 15, 12
    base = rng.integers(0, 4, size=6000).astype(np.uint8)
    records, offsets = [], [0]
    for a in range(6):
        g = base.copy()
        idx = rng.integers(0, len(g), size=60)
        g[idx] = (g[idx] + 1) % 4
        g[rng.integers(0, 5000):][:50] = 255
        parts = np.split(g, np.sort(rng.integers(0, len(g), size=1 + a % 2)))
        if a == 2:
            parts.insert(1, np.zeros(0, np.uint8))
        records += parts
        offsets.append(offsets[-1] + len(parts))
    offsets = np.asarray(offsets, np.uintp)
    oh, pos, rec, count, asm = hybrid.scan_chunk_device(
        records, k, w, 0, record_offsets=offsets, device='cpu')
    is_target = np.array([True, True, True, False, False, True])
    return (u64.to_numpy(oh), pos.numpy().astype(np.uint32), rec.numpy().astype(np.int32),
            asm.numpy().astype(np.int32), is_target, offsets, (oh, pos, rec, count, asm))


def _jax_chunk(oh, pos, rec):
    cap = 1 << max(10, (len(oh) - 1).bit_length())
    p_oh = np.zeros(cap, np.uint64)
    p_pos = np.zeros(cap, np.uint32)
    p_rec = np.full(cap, -1, np.int32)
    p_oh[:len(oh)], p_pos[:len(oh)], p_rec[:len(oh)] = oh, pos, rec
    return (jnp.asarray(p_oh), jnp.asarray(p_pos), jnp.asarray(p_rec), len(oh))


def _assert_equal(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope='module')
def jax_result(stream):
    oh, pos, rec, asm, is_target, offsets, _ = stream
    return jax_agg.aggregate(oh, pos, rec, asm, is_target, offsets)


def test_aggregate_matches_jax(stream, jax_result):
    oh, pos, rec, asm, is_target, offsets, _ = stream
    kmers, nodes, edges = jax_result
    assert (edges['weight'] > 1).any() and (nodes['n_tar'] > 1).any()
    _assert_equal(aggregate.aggregate(oh, pos, rec, asm, is_target, offsets, device='cpu'),
                  jax_result)
    # without record offsets, the assemblies come from the (rec, asm) pairs
    _assert_equal(aggregate.aggregate(oh, pos, rec, asm, is_target, device='cpu'), jax_result)


def test_aggregate_device_matches_jax(stream, jax_result):
    *_, chunk = stream
    is_target = stream[4]
    # two chunks split between records give the same graph as one
    oh, pos, rec, count, asm = chunk
    cut = int((rec < rec[count // 2]).sum())
    halves = [tuple(x[:cut] for x in (oh, pos, rec)) + (cut, asm[:cut]),
              tuple(x[cut:] for x in (oh, pos, rec)) + (count - cut, asm[cut:])]
    _assert_equal(aggregate.aggregate_device([chunk], is_target), jax_result)
    _assert_equal(aggregate.aggregate_device(halves, is_target), jax_result)


@pytest.fixture(scope='module')
def deferred(stream):
    oh, pos, rec, asm, is_target, offsets, chunk = stream
    want = jax_agg.aggregate_device([_jax_chunk(oh, pos, rec)], offsets, is_target, defer=True)
    got = aggregate.aggregate_device([chunk], is_target, defer=True)
    return got, want


def test_deferred_nodes_and_materialize(deferred, jax_result):
    got, want = deferred
    assert (got.n_kmers, got.n_nodes, got.n_edges) == (want.n_kmers, want.n_nodes, want.n_edges)
    np.testing.assert_array_equal(got.nodes, want.nodes)
    _assert_equal(got.materialize(), want.materialize())
    _assert_equal(got.materialize(), (jax_result[0], jax_result[2]))


@pytest.mark.parametrize('th', [0.0, 1.0, 1.7, 2.0, 3.0, 5.5, 1000.0])
def test_deferred_filter_edges(deferred, th):
    got, want = deferred
    _assert_equal([got.filter_edges(th)], [want.filter_edges(th)])


@pytest.mark.parametrize('frac', [0.0, 0.01, 0.3, 1.0])
def test_deferred_compact_kmers(deferred, frac):
    got, want = deferred
    nodes = want.nodes
    rng = np.random.default_rng(int(frac * 100))
    used = rng.choice(nodes['hash'], size=int(len(nodes) * frac), replace=False)
    keep, _, total = kept_node_layout(nodes, used)
    _assert_equal([got.compact_kmers(keep, total)], [want.compact_kmers(keep, total)])


def test_aggregate_empty():
    out = aggregate.aggregate(np.zeros(0, np.uint64), np.zeros(0, np.uint32),
                              np.zeros(0, np.int32), np.zeros(0, np.int32),
                              np.array([True]), device='cpu')
    assert [len(x) for x in out] == [0, 0, 0]
    g = aggregate.aggregate_device([], np.array([True]), defer=True)
    assert g.n_kmers == g.n_nodes == g.n_edges == 0
