"""seqwin_tpu_torch's whole pipeline on the CPU against the JAX package's
(`seqwin_tpu.run` with ``device_backend='numpy'``, its device-free build,
proven equal to its device engine): the same FASTAs give byte-equal
`assemblies.csv`, `signatures.fasta`, `signatures.csv` and `graph.npz`
(``no_filter``), and the same `config.json`; `results.seqwin` loads in a
fresh process."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import seqwin_tpu
import seqwin_tpu_torch

REPO = Path(__file__).resolve().parent.parent
N_TAR, N_NEG, GENOME_LEN = 4, 4, 40_000


def _write_genome(path: Path, root: np.ndarray, snp_rate: float, i: int, rng) -> None:
    """One assembly of two records cut from ``root`` with SNPs and an N run
    (the golden171 proxy's genome model)."""
    alphabet = np.frombuffer(b'ACGTN', dtype=np.uint8)
    n = len(root)
    g = root.copy()
    idx = rng.integers(0, n, size=int(n * snp_rate))
    g[idx] = (g[idx] + rng.integers(1, 4, size=idx.size)) % 4
    n0 = rng.integers(0, n - 500)
    g[n0:n0 + rng.integers(10, 300)] = 4
    cut = rng.integers(n // 4, 3 * n // 4)
    with open(path, 'w') as f:
        for ri, r in enumerate((g[:cut], g[cut:])):
            f.write(f'>proxy_{i}_{ri} record {ri}\n')
            seq = alphabet[r].tobytes().decode()
            for off in range(0, len(seq), 80):
                f.write(seq[off:off + 80] + '\n')


@pytest.fixture(scope='module')
def inputs(tmp_path_factory):
    """Targets from one root, non-targets from an 8%-diverged root; the
    target and non-target path lists."""
    tmp = tmp_path_factory.mktemp('proxy')
    rng = np.random.default_rng(171)
    root = rng.integers(0, 4, size=GENOME_LEN).astype(np.uint8)
    neg_root = root.copy()
    idx = rng.integers(0, GENOME_LEN, size=int(GENOME_LEN * 0.08))
    neg_root[idx] = (neg_root[idx] + rng.integers(1, 4, size=idx.size)) % 4
    lists = []
    for role, n, base, snp in (('tar', N_TAR, root, 0.005), ('neg', N_NEG, neg_root, 0.01)):
        paths = []
        for i in range(n):
            p = tmp / f'{role}_{i:03d}.fasta'
            _write_genome(p, base, snp, i, rng)
            paths.append(p)
        txt = tmp / f'{role}.txt'
        txt.write_text('\n'.join(map(str, paths)) + '\n')
        lists.append(txt)
    return lists


def _common(inputs, **kw):
    tar, neg = inputs
    return {**dict(tar_paths=tar, neg_paths=neg, title='run', run_mash=False,
                   run_blast=False, n_cpu=1), **kw}


@pytest.fixture(scope='module')
def reference(inputs, tmp_path_factory):
    """The JAX package's run and its no-filter run."""
    out = {}
    for name, kw in (('run', {}), ('raw', dict(no_filter=True))):
        prefix = tmp_path_factory.mktemp(f'jax_{name}')
        seqwin_tpu.run(seqwin_tpu.Config(prefix=prefix, device_backend='numpy',
                                          **_common(inputs, **kw)))
        out[name] = prefix / 'run'
    return out


VARIANTS = {'one_cpu': {}, 'n_cpu_2': dict(n_cpu=2), 'devices_2': dict(devices=2)}


@pytest.fixture(scope='module')
def port_runs(inputs, tmp_path_factory):
    out = {}
    for name, kw in VARIANTS.items():
        prefix = tmp_path_factory.mktemp(f'torch_{name}')
        seqwin = seqwin_tpu_torch.run(seqwin_tpu_torch.Config(
            prefix=prefix, device='cpu', **_common(inputs, **kw)))
        out[name] = (prefix / 'run', seqwin)
    return out


@pytest.mark.parametrize('variant', list(VARIANTS))
@pytest.mark.parametrize('name', ['assemblies.csv', 'signatures.fasta', 'signatures.csv'])
def test_outputs_byte_equal(reference, port_runs, variant, name):
    got = (port_runs[variant][0] / name).read_bytes()
    assert got == (reference['run'] / name).read_bytes()
    if name == 'signatures.fasta':
        assert got.count(b'>') >= 1


@pytest.mark.parametrize('variant', list(VARIANTS))
def test_config_json_equal(reference, port_runs, variant):
    want = json.loads((reference['run'] / 'config.json').read_text())
    out_dir = port_runs[variant][0]
    # the JAX run differs in its output prefix and its host build
    want.update(prefix=str(out_dir.parent), device_backend='auto', **VARIANTS[variant])
    assert json.loads((out_dir / 'config.json').read_text()) == want


@pytest.mark.parametrize('devices', [1, 2])
def test_no_filter_graph_npz_equal(inputs, reference, tmp_path, devices):
    seqwin_tpu_torch.run(seqwin_tpu_torch.Config(
        prefix=tmp_path, device='cpu', devices=devices, **_common(inputs, no_filter=True)))
    got = np.load(tmp_path / 'run' / 'graph.npz')
    want = np.load(reference['raw'] / 'graph.npz')
    assert sorted(got.files) == sorted(want.files) == ['edges', 'kmers', 'nodes', 'record_offsets']
    for key in want.files:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    assert len(got['kmers']) > 1000
    assert not (tmp_path / 'run' / 'signatures.fasta').exists()


def test_run_state_matches(reference, port_runs):
    """Thresholds, subgraphs and candidates equal the JAX run's, read back
    from its results.seqwin."""
    want = seqwin_tpu.load(reference['run'] / 'results.seqwin')
    _, got = port_runs['one_cpu']
    for field in ('n_tar', 'n_neg', 'penalty_th', 'edge_weight_th', 'min_nodes', 'max_nodes'):
        assert getattr(got.state, field) == getattr(want.state, field), field
    assert got.kmers.subgraphs == want.kmers.subgraphs
    np.testing.assert_array_equal(got.kmers.kmers, want.kmers.kmers)
    np.testing.assert_array_equal(got.kmers.nodes, want.kmers.nodes)
    assert [ck.path for ck in got.markers] == [ck.path for ck in want.markers]
    assert got.assemblies.record_ids == list(want.assemblies.record_ids)


def test_results_load_in_fresh_process(port_runs):
    """results.seqwin holds no tensor and no device graph, and loads in a
    process that has none of jax, seqwin_tpu, pandas or pydantic."""
    out_dir, seqwin = port_runs['one_cpu']
    data = (out_dir / 'results.seqwin').read_bytes()
    assert b'_rebuild_tensor' not in data and b'DeviceGraph' not in data
    code = (
        'import sys\n'
        f'sys.path.insert(0, {str(REPO)!r})\n'
        'from seqwin_tpu_torch import load\n'
        f'run = load({str(out_dir / "results.seqwin")!r})\n'
        "print(len(run.markers), run.markers[0].rep.seq[:20], run.kmers.kmers.shape[0])\n"
        "print([m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'seqwin_tpu', 'pandas', 'pydantic')])\n"
    )
    res = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         cwd=out_dir, timeout=120, env={**os.environ, 'CUDA_VISIBLE_DEVICES': ''})
    assert res.returncode == 0, res.stderr
    first, second = res.stdout.strip().splitlines()[-2:]
    assert first == f'{len(seqwin.markers)} {seqwin.markers[0].rep.seq[:20]} {len(seqwin.kmers.kmers)}'
    assert second == '[]'
