"""seqwin_tpu_torch's multi-host build (`parallel/multihost.py`) against the
JAX package's `seqwin_tpu/parallel/multihost.py`: the partition, batch and
record bookkeeping, the one-process build, and real two-process runs over a
gloo process group (this file's ``__main__`` block is their worker), each
byte-equal to the single-process build or run."""
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest

from seqwin_tpu_torch.parallel import multihost as MH

K, W = 9, 12
REPO = Path(__file__).resolve().parent.parent
ARRAYS = ('kmers', 'nodes', 'edges', 'record_offsets')


@pytest.mark.parametrize('sizes,n_parts', [
    ([100, 50, 200, 10, 10, 300, 100, 100, 40, 90], 3),
    ([300, 100, 400, 100, 500, 900, 200, 600], 2),
    ([5, 5], 4),                      # more processes than assemblies
    ([0, 0, 70, 0], 2),
    ([], 3),
])
def test_partition_matches_jax(sizes, n_parts):
    from seqwin_tpu.parallel import multihost as jmh

    parts = [MH.partition_indices(sizes, n_parts, p) for p in range(n_parts)]
    assert parts == [jmh.partition_indices(sizes, n_parts, p) for p in range(n_parts)]
    assert [i for part in parts for i in part] == list(range(len(sizes)))
    paths = [f'g{i}' for i in range(len(sizes))]
    assert ([MH.partition_paths(paths, sizes, n_parts, p) for p in range(n_parts)]
            == [jmh.partition_paths(paths, sizes, n_parts, p) for p in range(n_parts)])


@pytest.mark.parametrize('budget', [1, 250, 600, 10_000])
def test_size_batches_matches_jax(budget):
    from seqwin_tpu.parallel import multihost as jmh

    paths = ['a.fa', 'b.fa.gz', 'c.fa', 'd.fna', 'e.fa.gz', 'f.fa']
    sizes = [120, 100, 400, 30, 90, 500]
    got = MH._size_batches(paths, sizes, budget)
    assert got == jmh._size_batches(paths, sizes, budget)
    assert got[0][0] == 0 and got[-1][1] == len(paths)
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))


def test_record_bookkeeping_invariance():
    """For any process count the per-process record counts concatenate to
    the global vector and each process's first record is the global offset
    of its first assembly; one process exchanges nothing."""
    counts = np.array([3, 1, 4, 1, 5, 9, 2, 6], dtype=np.int64)
    sizes = [int(c) * 100 for c in counts]
    offsets = np.concatenate(([0], np.cumsum(counts)))
    for nproc in (1, 2, 3, 5):
        parts = [MH.partition_indices(sizes, nproc, p) for p in range(nproc)]
        np.testing.assert_array_equal(np.concatenate([counts[p] for p in parts if p]), counts)
        next_base = 0
        for part in parts:
            if part:
                assert int(offsets[part[0]]) == next_base
                next_base += int(counts[part].sum())
        assert next_base == int(counts.sum())
    np.testing.assert_array_equal(MH.exchange_record_counts(counts, 1), counts)
    assert MH.exchange_record_counts([], 1).dtype == np.int64
    ids = [('a', 'b'), (), ('c',)]
    assert MH.exchange_record_ids(ids, 1) == ids
    MH.initialize('127.0.0.1:1', 1, 0)  # one process: no group
    assert MH._world() == (1, 0)


def _write_fasta(path, records):
    with open(path, 'w') as f:
        for rid, g in records:
            f.write(f'>{rid}\n')
            s = np.frombuffer(b'ACGTN', np.uint8)[g].tobytes().decode()
            f.write(''.join(s[i:i + 70] + '\n' for i in range(0, len(s), 70)))


@pytest.fixture(scope='module')
def fastas(tmp_path_factory):
    """5 related assemblies: multi-record, N runs, one empty record; the
    paths, targets and a paths file for the workers."""
    tmp = tmp_path_factory.mktemp('mh_fastas')
    rng = np.random.default_rng(6)
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
    targets = [True, True, False, False, False]
    listing = tmp / 'paths.txt'
    listing.write_text(''.join(f'{p}\t{int(t)}\n' for p, t in zip(paths, targets)))
    return paths, targets, listing


@pytest.fixture(scope='module')
def single_build(fastas):
    from seqwin_tpu_torch.graph.build import build

    paths, targets, _ = fastas
    return build(paths, K, W, targets, device='cpu')


def _assert_build_equal(got, want):
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert [tuple(t) for t in got[4]] == [tuple(t) for t in want[4]]


def test_build_multihost_single_process_matches_jax(fastas, single_build, monkeypatch):
    """One process, low memory at a 1-base budget (one assembly per batch,
    merged on the host): the single build, and the JAX package's
    `build_multihost` on its CPU mesh."""
    import importlib

    import torch

    from seqwin_tpu.parallel.multihost import build_multihost as jax_build_multihost

    paths, targets, _ = fastas
    for name in ('seqwin_tpu.graph.build', 'seqwin_tpu_torch.graph.build'):
        monkeypatch.setattr(importlib.import_module(name), 'LOW_MEMORY_CHUNK_BASES', 1)
    got = MH.build_multihost(paths, K, W, targets, [torch.device('cpu')] * 3, low_memory=True)
    _assert_build_equal(got, single_build)
    _assert_build_equal(got, jax_build_multihost(paths, K, W, targets, low_memory=True))
    graph, offsets, ids = MH.build_multihost(paths, K, W, targets, [torch.device('cpu')] * 2,
                                             defer=True)
    assert graph.n_chunks == 2 and graph.record_codes is None
    kmers, edges = graph.materialize()
    _assert_build_equal((kmers, graph.nodes, edges, offsets, ids), single_build)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _two_processes(*args) -> None:
    """This file as the worker in two processes (ranks 0 and 1) of one gloo
    group; both must exit 0 within the timeout. Their output goes to
    files, so neither blocks on a full pipe."""
    port = _free_port()
    env = {**os.environ, 'PYTHONPATH': str(REPO)}
    logs = [tempfile.TemporaryFile() for _ in range(2)]
    procs = [subprocess.Popen([sys.executable, __file__, *args, str(pid), str(port)],
                              env=env, stdout=log, stderr=subprocess.STDOUT)
             for pid, log in enumerate(logs)]
    try:
        deadline = time.monotonic() + 300
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        log.seek(0)
        out = log.read().decode(errors='replace')
        log.close()
        assert p.returncode == 0, f'worker failed:\n{out[-4000:]}'


@pytest.mark.parametrize('low_memory', [False, True])
def test_two_process_build_matches_single(tmp_path, fastas, single_build, low_memory):
    """Two processes, two CPU shards each, each parsing its own assemblies:
    both processes hold the single build's arrays. With ``low_memory`` at a
    1-base budget every assembly is a batch, and in each the process that
    owns none of it still joins every collective."""
    _, _, listing = fastas
    _two_processes('build', str(listing), str(tmp_path), str(int(low_memory)))
    for pid in range(2):
        got = np.load(tmp_path / f'build{pid}.npz')
        ids = json.loads((tmp_path / f'build{pid}.json').read_text())
        _assert_build_equal([got[a] for a in ARRAYS] + [ids], single_build)
        assert len(got['kmers']) > 1000


def _genome_lists(tmp: Path, n_tar=3, n_neg=3, length=12_000):
    """Targets from one root with 0.5% SNPs, non-targets from an 8%-diverged
    root with 1%, each with an N run and cut into two records."""
    rng = np.random.default_rng(12)
    root = rng.integers(0, 4, size=length).astype(np.uint8)
    neg_root = root.copy()
    idx = rng.integers(0, length, size=int(length * 0.08))
    neg_root[idx] = (neg_root[idx] + rng.integers(1, 4, size=idx.size)) % 4
    lists = []
    for role, n, base, snp in (('tar', n_tar, root, 0.005), ('neg', n_neg, neg_root, 0.01)):
        paths = []
        for i in range(n):
            g = base.copy()
            idx = rng.integers(0, length, size=int(length * snp))
            g[idx] = (g[idx] + rng.integers(1, 4, size=idx.size)) % 4
            n0 = int(rng.integers(0, length - 300))
            g[n0:n0 + int(rng.integers(10, 300))] = 4
            cut = int(rng.integers(length // 4, 3 * length // 4))
            paths.append(tmp / f'{role}{i}.fa')
            _write_fasta(paths[-1], [(f'{role}{i}_0', g[:cut]), (f'{role}{i}_1', g[cut:])])
        lists.append(tmp / f'{role}.txt')
        lists[-1].write_text(''.join(f'{p}\n' for p in paths))
    return lists


RUN = dict(kmerlen=15, windowsize=20, min_len=60, run_mash=False, run_blast=False, n_cpu=1,
           sketch_mode='device')


def test_two_process_run_matches_single(tmp_path):
    """`run(Config(..., device='cpu', devices=2))` in two processes of one
    group, each with its own prefix, the device sketches re-parsing the
    FASTAs (the multi-host build keeps no codes): both write the
    single-process run's files."""
    from seqwin_tpu_torch import Config, run

    tar, neg = _genome_lists(tmp_path)
    run(Config(tar_paths=tar, neg_paths=neg, prefix=tmp_path, title='single', device='cpu',
               **RUN))
    _two_processes('run', str(tar), str(neg), str(tmp_path))
    want = tmp_path / 'single'
    assert (want / 'signatures.fasta').read_bytes().count(b'>') > 3
    for pid in range(2):
        got = tmp_path / f'rank{pid}' / 'single'
        for name in ('assemblies.csv', 'signatures.fasta', 'signatures.csv'):
            assert (got / name).read_bytes() == (want / name).read_bytes(), (pid, name)
        cfg = json.loads((want / 'config.json').read_text())
        cfg.update(prefix=str(tmp_path / f'rank{pid}'), devices=2)
        assert json.loads((got / 'config.json').read_text()) == cfg


def _worker(mode: str, *args: str) -> None:
    """One process of the two-process tests: ``build <paths.txt> <out dir>
    <low_memory 0|1> <rank> <port>`` or ``run <tar.txt> <neg.txt> <out dir>
    <rank> <port>``."""
    import torch.distributed as dist

    *args, rank, port = args
    os.environ['SEQWIN_TPU_MULTIHOST'] = f'127.0.0.1:{port},2,{rank}'
    if mode == 'build':
        import importlib

        from seqwin_tpu_torch.graph.build import build

        listing, out, low_memory = args
        paths, targets = zip(*(ln.split('\t') for ln in Path(listing).read_text().splitlines()))
        if low_memory == '1':
            importlib.import_module('seqwin_tpu_torch.graph.build').LOW_MEMORY_CHUNK_BASES = 1
        res = build(paths, K, W, [t == '1' for t in targets], devices=2, device='cpu',
                    low_memory=low_memory == '1')
        np.savez(Path(out) / f'build{rank}.npz', **dict(zip(ARRAYS, res[:4])))
        (Path(out) / f'build{rank}.json').write_text(json.dumps(res[4]))
    else:
        from seqwin_tpu_torch import Config, run

        tar, neg, out = args
        prefix = Path(out) / f'rank{rank}'
        prefix.mkdir()
        run(Config(tar_paths=tar, neg_paths=neg, prefix=prefix, title='single', device='cpu',
                   devices=2, **RUN))
    dist.destroy_process_group()


if __name__ == '__main__':
    _worker(*sys.argv[1:])
