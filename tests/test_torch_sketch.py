"""seqwin_tpu_torch's device MinHash sketches (`mash.py`) and spaced-seed
hashing (`ops/spaced.py`) on the CPU against the JAX package's
`seqwin_tpu/mash.py` and `seqwin_tpu/ops/spaced.py`: exact equality and the
dtype of every result, then whole runs with ``sketch_mode='device'``
against `seqwin_tpu.run(device_backend='numpy', sketch_mode='device')`."""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import seqwin_tpu
import seqwin_tpu.mash as jm
import seqwin_tpu.ops.spaced as js
import seqwin_tpu_torch
from seqwin_tpu_torch import mash as M
from seqwin_tpu_torch.ops import spaced as S
from seqwin_tpu_torch.ops import u64
from seqwin_tpu_torch.ops.hashing import M64

PATTERNS = ['1', '11011', '101101101', '1100110011', '110000000011', '10101']


def _codes(rng, n, n_frac=0.08):
    c = rng.integers(0, 4, size=n).astype(np.uint8)
    c[rng.random(n) < n_frac] = 255
    return c


def test_srol_by_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 64, size=4000, dtype=np.uint64)
    d = rng.integers(0, 2100, size=4000).astype(np.int64)
    got = S._srol_by(u64.from_numpy(x), torch.from_numpy(d))
    want = np.asarray(js._srol_by(jnp.asarray(x), jnp.asarray(d)))
    assert got.dtype == torch.int64 and want.dtype == np.uint64
    np.testing.assert_array_equal(u64.to_numpy(got), want)


@pytest.mark.parametrize('pattern', PATTERNS)
def test_spaced_hashes_match_jax(pattern):
    """The numpy copies and the torch device form against JAX's oracle,
    host and device functions, extended hashes included."""
    rng = np.random.default_rng(sum(map(ord, pattern)))
    codes = _codes(rng, int(rng.integers(len(pattern) + 1, 700)))
    ho, po = js.spaced_oracle(codes, pattern, n_hashes=3)
    for fn in (S.spaced_oracle, S.spaced_hashes_host):
        h, p = fn(codes, pattern, n_hashes=3)
        assert h.dtype == np.uint64 and p.dtype == np.int64
        np.testing.assert_array_equal(h, ho)
        np.testing.assert_array_equal(p, po)
    hd, pd, cnt = js.spaced_hashes_device(codes, pattern, n_hashes=3)
    cnt = int(cnt)
    h, p, count = S.spaced_hashes_device(torch.from_numpy(codes), pattern, n_hashes=3)
    assert count == cnt == len(po) > 0
    assert h.dtype == p.dtype == torch.int64 and h.shape == (cnt, 3)
    np.testing.assert_array_equal(u64.to_numpy(h), np.asarray(hd)[:cnt])
    np.testing.assert_array_equal(p.numpy(), np.asarray(pd)[:cnt])


@pytest.mark.parametrize('codes', [np.zeros(3, np.uint8), np.full(9, 255, np.uint8)],
                         ids=['shorter_than_k', 'all_invalid'])
def test_spaced_hashes_without_windows(codes):
    h, p, count = S.spaced_hashes_device(torch.from_numpy(codes), '10101', n_hashes=2)
    assert count == int(js.spaced_hashes_device(codes, '10101', n_hashes=2)[2]) == 0
    assert h.shape == (0, 2) and p.shape == (0,)
    h, p = S.spaced_hashes_host(codes, '10101', n_hashes=2)
    assert h.shape == (0, 2) and len(p) == 0


@pytest.mark.parametrize('pattern', [None, *PATTERNS, '1000100000001'])
def test_separator_run_matches_jax(pattern):
    assert M._separator_run(pattern) == jm._separator_run(pattern)


def _assemblies(rng, k):
    """Assemblies with N runs, empty records, records shorter than k, an
    all-N assembly and an assembly with no bases."""
    out = []
    for sizes in ([900, 0, 1200], [3000], [k - 1, 40, k], [700, 650, 30, 500],
                  [], [0, 0], [2500, 17]):
        out.append([_codes(rng, n, 0.02) for n in sizes])
    out.append([np.full(300, 255, np.uint8)])
    out[1].append(out[0][2].copy())  # a shared record: a Jaccard above 0
    return out


def _assert_sketches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint64
        np.testing.assert_array_equal(g, w)
        assert np.all(g[1:] > g[:-1])


@pytest.mark.parametrize('k', [15, 21, 32, 33, 63])
@pytest.mark.parametrize('sketchsize', [50, 5000])
def test_device_sketches_contiguous_match_jax(k, sketchsize):
    recs = _assemblies(np.random.default_rng(k), k)
    got = M.device_sketches(recs, k, sketchsize, device='cpu')
    _assert_sketches_equal(got, jm.device_sketches(recs, k, sketchsize))
    assert max(len(s) for s in got) == min(sketchsize, max(len(s) for s in got))
    assert [len(s) for s in got][4:6] == [0, 0] and len(got[-1]) == 0


@pytest.mark.parametrize('k', [15, 21, 32, 33, 63])
@pytest.mark.parametrize('sketchsize', [50, 5000])
def test_cut_sketches_contiguous_match_jax(k, sketchsize, monkeypatch):
    """The cut path (`cut_sketches`, the kernels' plain versions on the
    CPU) in chunks of at most 2,000 positions, so that several chunks run
    and the longer assemblies take one each. Only an assembly with fewer
    distinct k-mers than the sketch size under a cut below all-ones (the
    all-N one at 50) is redone in full."""
    recs = _assemblies(np.random.default_rng(k), k)
    monkeypatch.setattr(M, 'CHUNK_BASES', 2_000)
    got, candidates, fallbacks = M.cut_sketches(recs, k, sketchsize, torch.device('cpu'))
    _assert_sketches_equal(got, jm.device_sketches(recs, k, sketchsize))
    lengths = [M.stream_bases(r) for r in recs]
    short = [len(g) < sketchsize and M.cut_threshold(n, sketchsize) < M64
             for g, n in zip(got, lengths)]
    assert candidates > 0 and fallbacks == sum(short) == (sketchsize == 50)
    assert max(lengths) > 2_000 and 3 < len(M.chunk_plan(lengths, 2_000)) < len(recs)


def _repeat(rng):
    """A 37-base unit 300 times: 37 distinct 21-mers under a cut below
    all-ones, too few for a sketch of 50."""
    return [[_codes(rng, 20_000, 0.0)], [np.tile(_codes(rng, 37, 0.0), 300)]]


def _overflow(rng):
    """200 bases of a 4-base unit all of whose 21-mers hash below the cut
    of a sketch of 10 over 380 positions: the counter passes the slots."""
    unit = np.array([0, 3, 2, 1], np.uint8)
    return [[np.concatenate([np.tile(unit, 50), _codes(rng, 180, 0.0)])],
            [_codes(rng, 20_000, 0.0)]]


@pytest.mark.parametrize('make, sketchsize, redone', [(_repeat, 50, [1]), (_overflow, 10, [0])],
                         ids=['low_complexity_repeat', 'candidate_overflow'])
def test_cut_sketches_forced_fallbacks_match_jax(make, sketchsize, redone, monkeypatch):
    """An assembly the cut cannot settle is redone in full, and the
    sketches still equal the JAX package's."""
    recs = make(np.random.default_rng(sketchsize))
    monkeypatch.setattr(M, 'CHUNK_BASES', 8_000)
    got, _, fallbacks = M.cut_sketches(recs, 21, sketchsize, torch.device('cpu'))
    _assert_sketches_equal(got, jm.device_sketches(recs, 21, sketchsize))
    assert fallbacks == len(redone)


@pytest.mark.parametrize('sketchsize', [64, 4096])
@pytest.mark.parametrize('pattern', ['110101011', '110000000011'])
def test_device_sketches_spaced_match_jax(sketchsize, pattern):
    """Many short records: a junction hash would show at 4096 (the whole
    set of distinct hashes)."""
    rng = np.random.default_rng(sketchsize)
    recs = [[_codes(rng, int(n), 0.01) for n in rng.integers(5, 60, size=40)],
            [_codes(rng, 900, 0.0)], [], [_codes(rng, 5, 0.0)]]
    got = M.device_sketches(recs, 0, sketchsize, seed_pattern=pattern, device='cpu')
    _assert_sketches_equal(got, jm.device_sketches(recs, 0, sketchsize, seed_pattern=pattern))
    # the union of the records' own hashes, no junction hash
    union = {int(h) for c in recs[0] for h in S.spaced_hashes_host(c, pattern)[0][:, 0]}
    np.testing.assert_array_equal(got[0], np.array(sorted(union)[:sketchsize], np.uint64))
    assert len(union) > 64 and len(got[3]) == 0


@pytest.fixture(scope='module')
def sketch_sets():
    """JAX sketches of related, identical, disjoint, short and empty
    assemblies, grouped into the matrix cases."""
    rng = np.random.default_rng(3)
    a, b = _codes(rng, 5000, 0.0), _codes(rng, 5000, 0.0)
    c = a.copy()
    c[rng.integers(0, 5000, size=40)] = 2
    sk = jm.device_sketches([[a], [a.copy()], [b], [c], [a[:30]], [], [a[:2000], b[:900]]],
                            15, 300)
    return {'none': [], 'one': sk[:1], 'identical': sk[:2], 'disjoint': [sk[0], sk[2]],
            'many': sk, 'short': [sk[4], sk[0], sk[5], sk[4]]}


@pytest.mark.parametrize('case', ['none', 'one', 'identical', 'disjoint', 'many', 'short'])
def test_sketch_jaccard_matrix_matches_jax(sketch_sets, case):
    sketches = sketch_sets[case]
    got = M.sketch_jaccard_matrix(sketches, 300, device='cpu')
    want = jm.sketch_jaccard_matrix(sketches, 300)
    assert got.dtype == want.dtype == np.float64
    assert got.shape == (len(sketches), len(sketches))
    np.testing.assert_array_equal(got, want)
    if case == 'identical':
        assert (got == 1.0).all()
    if case == 'disjoint':
        assert got[0, 1] < 0.05
    if case == 'many':
        assert 0.5 < got[0, 3] < 1.0 and len(set(got.ravel().tolist())) > 5


# --- whole runs ---

def _genome_lists(tmp_path, n_tar=3, n_neg=3, length=12_000):
    """Targets from one root with 0.5% SNPs, non-targets from an
    8%-diverged root with 1%, each with an N run and cut into two records."""
    rng = np.random.default_rng(11)
    root = rng.integers(0, 4, size=length).astype(np.uint8)
    neg_root = root.copy()
    idx = rng.integers(0, length, size=int(length * 0.08))
    neg_root[idx] = (neg_root[idx] + rng.integers(1, 4, size=idx.size)) % 4
    alphabet = np.frombuffer(b'ACGTN', np.uint8)
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
            p = tmp_path / f'{role}{i}.fa'
            p.write_text(''.join(f'>{role}{i}_{j}\n{alphabet[r].tobytes().decode()}\n'
                                 for j, r in enumerate((g[:cut], g[cut:]))))
            paths.append(p)
        txt = tmp_path / f'{role}.txt'
        txt.write_text(''.join(f'{p}\n' for p in paths))
        lists.append(txt)
    return lists


K_W = dict(kmerlen=15, windowsize=20, min_len=60, run_mash=False, run_blast=False, n_cpu=1)
RUNS = {
    'plain': {},
    'seed_pattern': dict(seed_pattern='1101100111011'),
    'devices_2': dict(devices=2),
    'low_memory': dict(low_memory=True),
}
FILES = ('assemblies.csv', 'signatures.fasta', 'signatures.csv')


@pytest.fixture(scope='module')
def jax_runs(tmp_path_factory):
    """Inputs and the JAX package's sketch runs on them (its host build),
    with and without a seed pattern."""
    tmp = tmp_path_factory.mktemp('sketch_runs')
    tar, neg = _genome_lists(tmp)
    out = {}
    for name, kw in (('plain', {}), ('seed_pattern', RUNS['seed_pattern'])):
        seqwin = seqwin_tpu.run(seqwin_tpu.Config(
            tar_paths=tar, neg_paths=neg, prefix=tmp, title=name,
            device_backend='numpy', sketch_mode='device', **K_W, **kw))
        assert (tmp / name / 'signatures.fasta').read_bytes().count(b'>') > 3
        out[name] = (tmp / name, seqwin)
    minimizer = seqwin_tpu.run(seqwin_tpu.Config(
        tar_paths=tar, neg_paths=neg, prefix=tmp, title='minimizer',
        device_backend='numpy', sketch_mode='minimizer', **K_W))
    # the device estimate differs from the minimizer one on these inputs
    assert minimizer.state.penalty_th != out['plain'][1].state.penalty_th
    return tar, neg, out


@pytest.mark.parametrize('case', list(RUNS))
def test_sketch_mode_device_run_matches_jax(tmp_path, jax_runs, case, monkeypatch):
    """`run(Config(..., sketch_mode='device'))` on the CPU: the JAX run's
    files, config.json (but for the fields the runs set apart), Jaccard
    matrix (float64) and thresholds."""
    if case == 'low_memory':
        import importlib

        monkeypatch.setattr(importlib.import_module('seqwin_tpu_torch.graph.build'),
                            'LOW_MEMORY_CHUNK_BASES', 2000)
    tar, neg, runs = jax_runs
    want_dir, want = runs['seed_pattern' if case == 'seed_pattern' else 'plain']
    got = seqwin_tpu_torch.run(seqwin_tpu_torch.Config(
        tar_paths=tar, neg_paths=neg, prefix=tmp_path, title='run', device='cpu',
        sketch_mode='device', **K_W, **RUNS[case]))
    for name in FILES:
        assert (tmp_path / 'run' / name).read_bytes() == (want_dir / name).read_bytes(), name
    cfg = json.loads((want_dir / 'config.json').read_text())
    cfg.update(prefix=str(tmp_path), title='run', device_backend='auto', **RUNS[case])
    assert json.loads((tmp_path / 'run' / 'config.json').read_text()) == cfg
    assert got.mash.dtype == want.mash.dtype == np.float64
    np.testing.assert_array_equal(got.mash, want.mash)
    assert got.state.penalty_th == want.state.penalty_th
    assert got.state.edge_weight_th == want.state.edge_weight_th
