"""seqwin_tpu_torch's multi-device build (`parallel/distributed.py`) on CPU
shards against the JAX package's `parallel/distributed.py` on its 8 CPU host
devices, and against the port's single-device build."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seqwin_tpu.parallel import distributed as jd
from seqwin_tpu_torch.engine.aggregate import aggregate_device
from seqwin_tpu_torch.engine.hybrid import scan_chunk_device
from seqwin_tpu_torch.graph.build import build, build_deferred
from seqwin_tpu_torch.graph.build import kept_node_layout
from seqwin_tpu_torch.ops import u64
from seqwin_tpu_torch.parallel import distributed as D

K, W = 9, 12


def _random_records(rng, sizes, n_frac=0.01):
    out = []
    for n in sizes:
        c = rng.integers(0, 4, size=n).astype(np.uint8)
        c[rng.random(n) < n_frac] = 255
        out.append(c)
    return out


def _hashes(n, seed):
    """uint64 hashes, three quarters with the top bit set."""
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
    h[: 3 * n // 4] |= np.uint64(1 << 63)
    return h


@pytest.mark.parametrize('n_dev', [1, 2, 3, 8])
def test_buckets_match_jax(n_dev):
    h = _hashes(5000, n_dev)
    live = np.random.default_rng(1).random(5000) < 0.8
    t, tl = u64.from_numpy(h), torch.from_numpy(live)
    np.testing.assert_array_equal(
        D._hash_bucket(t, tl, n_dev).numpy(),
        np.asarray(jd._hash_bucket(jnp.asarray(h), jnp.asarray(live), n_dev)))
    np.testing.assert_array_equal(
        D._pair_bucket(t, tl, n_dev).numpy(),
        np.asarray(jd._pair_bucket(jnp.asarray(h), jnp.asarray(live), n_dev)))
    assert D._pair_boundaries(n_dev) == jd._pair_boundaries(n_dev)
    np.testing.assert_array_equal(D._pair_bucket_host(h, n_dev), jd._pair_bucket_host(h, n_dev))
    assert D._pair_bucket(t, tl, n_dev)[tl].max() < n_dev


@pytest.mark.parametrize('n_dev', [1, 2, 8])
def test_bucket_counts_match_bincount(n_dev):
    """The sync-free histogram equals bincount, dead entries left out."""
    bucket = torch.from_numpy(np.random.default_rng(n_dev).integers(0, n_dev + 1, size=3000))
    np.testing.assert_array_equal(D._bucket_counts(bucket, n_dev).numpy(),
                                  torch.bincount(bucket, minlength=n_dev + 1)[:n_dev].numpy())
    assert D._bucket_counts(bucket[:0], n_dev).tolist() == [0] * n_dev


@pytest.mark.parametrize('lengths,n_dev', [
    ([100, 50, 200, 10, 10, 300, 100, 100, 40, 90], 3),
    ([1000] * 8, 8),
    ([5, 7, 9, 11], 8),           # more shards than records: empty shards
    ([0, 0, 500, 0, 20], 2),
])
def test_partition_records_matches_jax(lengths, n_dev):
    np.testing.assert_array_equal(D.partition_records(lengths, n_dev),
                                  jd.partition_records(lengths, n_dev))


@pytest.mark.parametrize('n_dev', [2, 8])
def test_count_prepass_matches_jax(n_dev):
    """Counts and both histograms on the data of the JAX package's
    histogram regression test; the JAX pfx spec's count is the larger of
    the final and the clean-only count."""
    rng = np.random.default_rng(7)
    records = _random_records(rng, [30_000, 21_000, 27_000, 35_000], n_frac=0.003)
    shard_of = jd.partition_records([len(c) for c in records], n_dev)
    codes, starts, patch_pos, patch_z, _, n, offset = jd._shard_layout(
        records, shard_of, n_dev, K, W, use_pallas=False)
    mesh = jd.make_mesh(n_dev)
    want = {}
    for extract in ('topk', 'pfx'):
        spec = jd.ShardSpec(k=K, w=W, n_bases=n, offset=offset, emit_cap=0,
                            bucket_cap=0, use_pallas=False, extract=extract)
        want[extract] = [np.asarray(o) for o in jd._sharded_count_jit(
            jax.device_put(codes), jax.device_put(patch_pos), jax.device_put(patch_z),
            jax.device_put(starts), spec, n_dev, mesh)]
    shards = D._shard_layout(records, shard_of, [torch.device('cpu')] * n_dev, K, W, None)
    for d, s in enumerate(shards):
        if s is None:
            assert want['topk'][0][d] == 0 and not want['topk'][2][d].any()
            continue
        count, clean, e_hist, p_hist = D._count_step(
            s['codes'], s['starts'], s['patch_pos'], s['patch_z'], K, W, n_dev)
        assert int(count) == want['topk'][0][d]
        assert max(int(count), int(clean)) == want['pfx'][0][d]
        np.testing.assert_array_equal(e_hist.numpy(), want['topk'][2][d])
        np.testing.assert_array_equal(p_hist.numpy(), want['topk'][3][d])
        assert e_hist.sum() > 1000 and (e_hist > 0).all()


@pytest.fixture(scope='module')
def arrays_case():
    rng = np.random.default_rng(42)
    records = _random_records(rng, [700, 1200, 150, 950, 2000, 64, 800, 0, 500, 300],
                              n_frac=0.02)
    offsets = np.array([0, 2, 5, 8, 10], dtype=np.uintp)  # 4 assemblies
    targets = [True, True, False, False]
    chunk = scan_chunk_device(records, K, W, 0, record_offsets=offsets, device='cpu')
    single = aggregate_device([chunk], np.asarray(targets))
    return records, offsets, targets, single


@pytest.mark.parametrize('n_dev', [1, 2, 3, 8])
def test_build_distributed_arrays_matches_jax_and_single(arrays_case, n_dev):
    records, offsets, targets, single = arrays_case
    got = D.build_distributed_arrays(records, offsets, targets, K, W, ['cpu'] * n_dev)
    want = jd.build_distributed_arrays(records, offsets, targets, K, W, jd.make_mesh(n_dev))
    lengths = np.array([len(c) for c in records])
    shard_of = D.partition_records(lengths, n_dev)
    assert got[3] == sum(lengths[shard_of == d].sum() > 0 for d in range(n_dev))
    for a, b, c in zip(got[:3], want, single):
        assert a.dtype == b.dtype == c.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert len(got[0]) > 500


def test_build_distributed_arrays_empty_shards(arrays_case):
    """Shards without bases take part only as owners."""
    records, offsets, targets, single = arrays_case
    few = records[:4]
    offs = np.array([0, 2, 4], dtype=np.uintp)
    chunk = scan_chunk_device(few, K, W, 0, record_offsets=offs, device='cpu')
    want = aggregate_device([chunk], np.asarray([True, False]))
    got = D.build_distributed_arrays(few, offs, [True, False], K, W, ['cpu'] * 8)
    assert got[3] < 8
    for a, b in zip(got[:3], want):
        np.testing.assert_array_equal(a, b)


def _write_fasta(path, records):
    with open(path, 'w') as f:
        for rid, g in records:
            f.write(f'>{rid}\n')
            s = np.frombuffer(b'ACGTN', np.uint8)[g].tobytes().decode()
            f.write(''.join(s[i:i + 70] + '\n' for i in range(0, len(s), 70)))


@pytest.fixture(scope='module')
def fastas(tmp_path_factory):
    """5 related assemblies: multi-record, N runs, one empty record."""
    tmp = tmp_path_factory.mktemp('dist_fastas')
    rng = np.random.default_rng(5)
    base = rng.integers(0, 4, size=12000).astype(np.uint8)
    paths = []
    for i in range(5):
        g = base.copy()
        idx = rng.integers(0, len(g), size=120)
        g[idx] = (g[idx] + 1) % 4
        g[3000 + 50 * i:3080 + 50 * i] = 4
        parts = np.split(g, np.sort(rng.integers(0, len(g), size=1 + i % 3)))
        recs = [(f'a{i}_r{j}', p) for j, p in enumerate(parts)]
        if i == 2:
            recs.insert(1, ('empty', np.zeros(0, np.uint8)))
        paths.append(tmp / f'g{i}.fa')
        _write_fasta(paths[-1], recs)
    return paths, [True, True, False, False, False]


@pytest.fixture(scope='module')
def single_build(fastas):
    paths, targets = fastas
    return build(paths, K, W, targets, device='cpu')


def test_build_devices_matches_single_and_jax(fastas, single_build):
    paths, targets = fastas
    got = build(paths, K, W, targets, n_cpu=2, devices=4, device='cpu')
    want = jd.build_distributed(paths, K, W, targets, mesh=jd.make_mesh(4))
    for a, b, c in zip(got[:4], single_build[:4], want[:4]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert got[4] == single_build[4] == want[4]
    assert (got[2]['weight'] > 1).any() and (got[1]['n_tar'] > 1).any()


@pytest.fixture(scope='module')
def deferred_pair(fastas):
    paths, targets = fastas
    return (build_deferred(paths, K, W, targets, devices=3, device='cpu'),
            build_deferred(paths, K, W, targets, device='cpu'))


def test_build_deferred_devices_matches_single(deferred_pair):
    (g, offsets, ids), (s, s_offsets, s_ids) = deferred_pair
    np.testing.assert_array_equal(offsets, s_offsets)
    assert ids == s_ids and g.n_chunks == 3
    np.testing.assert_array_equal(g.nodes, s.nodes)
    for a, b in zip(g.materialize(), s.materialize()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('th', [0.0, 1.0, 2.5])
def test_deferred_devices_filter_edges(deferred_pair, th):
    (g, *_), (s, *_) = deferred_pair
    np.testing.assert_array_equal(g.filter_edges(th), s.filter_edges(th))


@pytest.mark.parametrize('frac', [0.05, 0.5])
def test_deferred_devices_compact_kmers(deferred_pair, frac):
    (g, *_), (s, *_) = deferred_pair
    rng = np.random.default_rng(int(frac * 100))
    used = rng.choice(g.nodes['hash'], size=int(g.n_nodes * frac), replace=False)
    keep, _, total = kept_node_layout(g.nodes, used)
    np.testing.assert_array_equal(g.compact_kmers(keep, total), s.compact_kmers(keep, total))


def test_prepass_disagreement_raises(arrays_case, monkeypatch):
    """A minimizer histogram that differs from the step's own bucket counts
    (same total) is caught after the merge."""
    records, offsets, targets, _ = arrays_case
    count_step = D._count_step

    def skewed(*args):
        count, clean, e_hist, p_hist = count_step(*args)
        return count, clean, e_hist + torch.tensor([1, -1]), p_hist

    monkeypatch.setattr(D, '_count_step', skewed)
    with pytest.raises(RuntimeError, match='minimizer block sizes'):
        D.build_distributed_arrays(records, offsets, targets, K, W, ['cpu'] * 2)


# record lengths, shard count, records the build sequence-shards
OVERSIZED = {
    'middle': ([3000, 4000, 100_000, 2000, 5000, 3000], 4, 1),
    'in_a_row': ([3000, 150_000, 140_000, 2000, 4000, 3000], 8, 2),
    'first': ([100_000, 3000, 2000, 4000], 4, 1),
    # one followed by a record on the last shard: the plain layout
    'infeasible': ([1000] * 6 + [100_000, 1000], 3, 0),
}


def _oversized_case(case):
    lengths, n_dev, n_sharded = OVERSIZED[case]
    rng = np.random.default_rng(len(lengths) * n_dev)
    records = _random_records(rng, lengths, n_frac=0.005)
    for c in records:
        if len(c) > 50_000:
            s = int(rng.integers(0, len(c) - 20_000))
            c[s:s + int(rng.integers(100, 20_000))] = 255
    offsets = np.array([0, 2, len(records) - 1, len(records)], dtype=np.uintp)
    return records, offsets, [True, False, True], n_dev, n_sharded


@pytest.mark.parametrize('case', list(OVERSIZED))
def test_assign_with_oversized_matches_jax(case):
    lengths, n_dev, _ = OVERSIZED[case]
    over = {i for i, ln in enumerate(lengths) if ln > 50_000}
    got = D._assign_with_oversized(lengths, over, n_dev)
    want, _ = jd._assign_with_oversized(lengths, over, n_dev)
    assert (got is None) == (want is None) == (case == 'infeasible')
    if got is not None:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('case', list(OVERSIZED))
def test_oversized_records_match_jax_and_single(case, monkeypatch):
    """Records above the per-shard budget are sequence-sharded and routed
    after the stream of the shard they terminate: the arrays equal the JAX
    package's `build_distributed_arrays` and the single-device build."""
    records, offsets, targets, n_dev, n_sharded = _oversized_case(case)
    sharded = []
    scan = D.scan_record_sharded
    monkeypatch.setattr(D, 'scan_record_sharded',
                        lambda codes, *a: sharded.append(len(codes)) or scan(codes, *a))
    got = D.build_distributed_arrays(records, offsets, targets, K, W, ['cpu'] * n_dev)
    want = jd.build_distributed_arrays(records, offsets, targets, K, W, jd.make_mesh(n_dev))
    chunk = scan_chunk_device(records, K, W, 0, record_offsets=offsets, device='cpu')
    single = aggregate_device([chunk], np.asarray(targets))
    assert len(sharded) == n_sharded
    for a, b, c in zip(got[:3], want, single):
        assert a.dtype == b.dtype == c.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert len(got[0]) > 1000 and (got[2]['weight'] > 1).any()


@pytest.mark.parametrize('n_dev', [2, 3, 8])
def test_scan_record_sharded_matches_whole_scan(n_dev):
    """One record over n_dev shards: at most n_dev blocks, one per shard,
    and the concatenated kept streams equal the scan of the whole record."""
    rng = np.random.default_rng(n_dev)
    codes = _random_records(rng, [90_000], n_frac=0.003)[0]
    codes[30_000:52_000] = 255  # an N desert wider than a block
    offsets = np.array([0, 3, 5], dtype=np.uintp)
    plan = D.sharded_block_plan(codes, K, W, n_dev)
    assert 1 < len(plan) <= n_dev
    got = D.scan_record_sharded(codes, K, W, ['cpu'] * n_dev, 4, offsets, 'cpu')
    want = scan_chunk_device([codes], K, W, 4, record_offsets=offsets, device='cpu')
    for a, b in zip(got, (want[0], want[1], want[2], want[4])):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert set(got[3].tolist()) == {1} and set(got[2].tolist()) == {4}


def test_build_distributed_arrays_rec_base0():
    """rec_base0 globalizes record ids and assemblies (the low-memory
    batches' bookkeeping), for stream and sequence-sharded records alike."""
    rng = np.random.default_rng(3)
    records = _random_records(rng, [500, 800, 100_000, 400])
    # records 5..8 of a larger run: assemblies span 4..9
    offsets = np.array([0, 5, 7, 9], dtype=np.uintp)
    targets = [True, False, True]
    got = D.build_distributed_arrays(records, offsets, targets, K, W, ['cpu'] * 4, rec_base0=5)
    want = jd.build_distributed_arrays(records, offsets, targets, K, W, jd.make_mesh(4),
                                       rec_base0=5)
    for a, b in zip(got[:3], want):
        np.testing.assert_array_equal(a, b)
    assert set(np.unique(got[0]['record_idx'])) == {5, 6, 7, 8}


@pytest.fixture
def low_memory_budget(monkeypatch):
    """Set the low-memory chunk budget of both packages."""
    import importlib

    def set_budget(bases):
        for name in ('seqwin_tpu.graph.build', 'seqwin_tpu_torch.graph.build'):
            monkeypatch.setattr(importlib.import_module(name), 'LOW_MEMORY_CHUNK_BASES', bases)
    return set_budget


@pytest.mark.parametrize('chunk_bases', [1, 2048, 8000])
def test_build_distributed_low_memory_matches_jax(fastas, single_build, low_memory_budget,
                                                  chunk_bases):
    """Whole-assembly batches closed once they reach n_dev x the budget
    (1: one assembly per batch), merged on the host: byte-equal to the JAX
    package's `build_distributed(low_memory=True)` and the unbatched
    build."""
    paths, targets = fastas
    low_memory_budget(chunk_bases)
    got = D.build_distributed(paths, K, W, targets, ['cpu'] * 4, low_memory=True, defer=True)
    want = jd.build_distributed(paths, K, W, targets, mesh=jd.make_mesh(4), low_memory=True)
    g, offsets, ids = got
    kmers, edges = g.materialize()
    for a, b, c in zip((kmers, g.nodes, edges, offsets), want[:4], single_build[:4]):
        assert a.dtype == b.dtype == c.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert ids == want[4] == single_build[4]
    # batches: a new one after the assembly that reaches 4 x chunk_bases
    sizes = [sum(len(c) for c in _parse(p)) for p in paths]
    batches, acc = 0, 0
    for n in sizes:
        acc += n
        if acc >= 4 * chunk_bases:
            batches, acc = batches + 1, 0
    batches += acc > 0
    assert g.n_chunks >= batches == {1: 5, 2048: 5, 8000: 2}[chunk_bases]


def _parse(path):
    from seqwin_tpu_torch.io.fasta import parse_fasta_codes

    return parse_fasta_codes(str(path))[1]


def test_build_low_memory_devices_cli_path(fastas, single_build, low_memory_budget):
    """`build(..., low_memory=True, devices=N)` (the CLI composition) takes
    the batched multi-device build and matches the plain build."""
    paths, targets = fastas
    low_memory_budget(1)
    got = build(paths, K, W, targets, low_memory=True, devices=3, device='cpu')
    for a, b in zip(got[:4], single_build[:4]):
        np.testing.assert_array_equal(a, b)
    assert got[4] == single_build[4]


def test_merge_graph_parts_matches_jax(arrays_case):
    """Per-batch builds of whole assemblies merge into the single build,
    as the JAX package's merge does; one part passes through."""
    records, offsets, targets, single = arrays_case
    parts = []
    for a0, a1 in ((0, 1), (1, 3), (3, 4)):
        r0, r1 = int(offsets[a0]), int(offsets[a1])
        parts.append(D.build_distributed_arrays(records[r0:r1], offsets[:a1 + 1], targets,
                                                K, W, ['cpu'] * 2, rec_base0=r0)[:3])
    got = D.merge_graph_parts(parts)
    want = jd.merge_graph_parts(parts)
    for a, b, c in zip(got, want, single):
        assert a.dtype == b.dtype == c.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert D.merge_graph_parts(parts[:1]) is parts[0]


@pytest.mark.parametrize('env', ['', '1', '127.0.0.1:1,1,0'])
def test_multihost_env_single_process_matches(fastas, single_build, monkeypatch, env):
    """``SEQWIN_TPU_MULTIHOST`` in one process (no group, or a group of one)
    takes the multi-host build over ``devices`` CPU shards: the single
    build's arrays."""
    paths, targets = fastas
    monkeypatch.setenv('SEQWIN_TPU_MULTIHOST', env)
    graph, offsets, ids = build_deferred(paths, K, W, targets, devices=4, device='cpu')
    kmers, edges = graph.materialize()
    for a, b in zip((kmers, graph.nodes, edges, offsets), single_build[:4]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ids == single_build[4] and graph.n_chunks == 4
    assert not torch.distributed.is_initialized()


def test_devices_map_to_cards(monkeypatch):
    """0 means every card; a request above the cards present takes them all."""
    import importlib

    B = importlib.import_module('seqwin_tpu_torch.graph.build')
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
    cuda = torch.device('cuda')
    assert B._shard_devices(0, cuda) == [torch.device('cuda', 0), torch.device('cuda', 1)]
    assert B._shard_devices(8, cuda) == [torch.device('cuda', 0), torch.device('cuda', 1)]
    assert len(B._shard_devices(1, cuda)) == 1
    assert B._shard_devices(3, torch.device('cpu')) == [torch.device('cpu')] * 3
