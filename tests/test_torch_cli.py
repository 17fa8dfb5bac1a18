"""seqwin_tpu_torch's Config and CLI against the JAX package's: the same
validation (exception types and messages), the same `config.json`, the
same option surface, the same Config from the same command line; low
memory, the host backends and the device sketches give the JAX package's
files."""
import argparse
import dataclasses
import json
import pickle
from enum import Enum

import numpy as np
import pytest
import torch

import seqwin_tpu.cli as jax_cli
import seqwin_tpu_torch.cli as cli
from seqwin_tpu.config import Config as JaxConfig
from seqwin_tpu_torch import run
from seqwin_tpu_torch.config import Config, SecretStr


def _touch_inputs(tmp_path):
    tar = tmp_path / 'tar.txt'
    neg = tmp_path / 'neg.txt'
    tar.write_text('')
    neg.write_text('')
    return tar, neg


# the bad inputs of tests/test_config.py, and the other validators
BAD = {
    'missing_files': lambda t, n, d: dict(tar_paths=d / 'nope.txt', neg_paths=d / 'nope2.txt'),
    'dir_as_file': lambda t, n, d: dict(tar_paths=d, neg_paths=n),
    'file_as_dir': lambda t, n, d: dict(tar_dir=t, neg_paths=n),
    'target_only': lambda t, n, d: dict(tar_paths=t),
    'non_target_only': lambda t, n, d: dict(neg_paths=n),
    'penalty_th': lambda t, n, d: dict(tar_paths=t, neg_paths=n, penalty_th=1.5),
    'stringency': lambda t, n, d: dict(tar_paths=t, neg_paths=n, stringency=11),
    'max_len': lambda t, n, d: dict(tar_paths=t, neg_paths=n, min_len=200, max_len=100),
    'devices': lambda t, n, d: dict(tar_paths=t, neg_paths=n, devices=-1),
    'seed_chars': lambda t, n, d: dict(tar_paths=t, neg_paths=n, seed_pattern='1021'),
    'seed_ends': lambda t, n, d: dict(tar_paths=t, neg_paths=n, seed_pattern='0110'),
    'level': lambda t, n, d: dict(tar_paths=t, neg_paths=n, level='bogus'),
}


@pytest.mark.parametrize('case', list(BAD))
def test_config_rejects_like_jax(tmp_path, case):
    tar, neg = _touch_inputs(tmp_path)
    kwargs = BAD[case](tar, neg, tmp_path)
    with pytest.raises(Exception) as want:
        JaxConfig(prefix=tmp_path, **kwargs)
    with pytest.raises(Exception) as got:
        Config(prefix=tmp_path, **kwargs)
    # pydantic wraps a validator's ValueError in a ValidationError, itself
    # a ValueError, whose text holds the validator's message
    assert isinstance(want.value, ValueError) and isinstance(got.value, ValueError)
    if case != 'level':
        assert str(got.value) in str(want.value)


def test_taxa_without_datasets_raise_like_jax(tmp_path, monkeypatch):
    import seqwin_tpu.config as jax_config
    import seqwin_tpu_torch.config as config

    monkeypatch.setattr(jax_config, 'HAS_DATASETS', False)
    monkeypatch.setattr(config, 'HAS_DATASETS', False)
    with pytest.raises(FileNotFoundError) as want:
        JaxConfig(tar_taxa=['x'], neg_taxa=['y'], prefix=tmp_path)
    with pytest.raises(FileNotFoundError) as got:
        Config(tar_taxa=['x'], neg_taxa=['y'], prefix=tmp_path)
    assert str(got.value) == str(want.value)


CONFIGS = {
    'defaults': {},
    'options': dict(api_key='secret-key', penalty_th=1, level='scaffold', source='refseq',
                    max_len=900, seed_pattern='11011', devices=0, title='t é'),
    'profile': dict(profile_dir='prof', penalty_th_cap=1, no_filter=True, tar_taxa=None),
    'empty_key': dict(api_key='', download_only=True),
}


@pytest.mark.parametrize('case', list(CONFIGS))
@pytest.mark.parametrize('indent', [None, 4])
def test_model_dump_json_matches_jax(tmp_path, monkeypatch, case, indent):
    """config.json bytes equal the pydantic dump's: fields in order, enums
    as values, paths as strings, the API key masked, then ``version``;
    ``device`` left out."""
    monkeypatch.chdir(tmp_path)
    tar, neg = _touch_inputs(tmp_path)
    kwargs = dict(tar_paths=tar, neg_paths=neg, **CONFIGS[case])
    got = Config(device='cpu', **kwargs).model_dump_json(indent=indent)
    assert got == JaxConfig(**kwargs).model_dump_json(indent=indent)
    assert 'secret-key' not in got and 'device"' not in got
    assert json.loads(got)['prefix'] == str(tmp_path.resolve())


def test_config_frozen_and_pickles(tmp_path):
    tar, neg = _touch_inputs(tmp_path)
    cfg = Config(tar_paths=tar, neg_paths=neg, prefix=tmp_path, api_key='s3cr3t')
    assert cfg.tar_paths.is_absolute() and cfg.prefix == tmp_path.resolve()
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.kmerlen = 5
    again = pickle.loads(pickle.dumps(cfg))
    assert again == cfg and again.api_key.get_secret_value() == 's3cr3t'
    assert isinstance(cfg.api_key, SecretStr) and 's3cr3t' not in repr(cfg)


def _actions(parser: argparse.ArgumentParser) -> dict:
    return {a.dest: a for a in parser._actions}


def test_parser_parity():
    """Every option of the JAX CLI, with the same flags, dest, default,
    choices, type and action kind."""
    got, want = _actions(cli.build_parser()), _actions(jax_cli.build_parser())
    assert list(got) == list(want)
    for dest, w in want.items():
        g = got[dest]
        assert g.option_strings == w.option_strings, dest
        assert type(g) is type(w), dest
        assert (g.default, g.choices, g.type, g.nargs, g.const) == \
            (w.default, w.choices, w.type, w.nargs, w.const), dest


def _value(v):
    if isinstance(v, Enum):
        return v.value
    if hasattr(v, 'get_secret_value'):
        return v.get_secret_value()
    return v


ARGVS = [
    ['--kmerlen', '17', '--windowsize', '10', '--no-mash', '--no-blast', '--threads', '3',
     '--seed', '7', '--stringency', '8', '--min-len', '50', '--max-len', '300'],
    ['-k', '15', '-w', '20', '-s', '2', '-p', '1', '--penalty-th', '0.1', '--no-filter',
     '--overwrite', '--title', 'x', '--level', 'complete', '--source', 'refseq', '--annotated',
     '--exclude-mag', '--no-gzip', '--api-key', 'abc', '--low-memory', '--backend', 'numpy',
     '--devices', '3', '--sketch-mode', 'device', '--seed-pattern', '10101'],
]


@pytest.mark.parametrize('argv', ARGVS)
def test_main_maps_options_like_jax(tmp_path, monkeypatch, argv):
    tar, neg = _touch_inputs(tmp_path)
    captured = {}
    monkeypatch.setattr('seqwin_tpu.core.run', lambda c: captured.setdefault('jax', c))
    monkeypatch.setattr('seqwin_tpu_torch.core.run', lambda c: captured.setdefault('port', c))
    argv = ['--tar-paths', str(tar), '--neg-paths', str(neg), '--prefix', str(tmp_path), *argv]
    assert jax_cli.main(argv) == 0
    assert cli.main(argv) == 0
    jax_cfg, cfg = captured['jax'], captured['port']
    names = [f.name for f in dataclasses.fields(cfg)]
    assert names == list(type(jax_cfg).model_fields) + ['device']
    for name in names[:-1]:
        assert _value(getattr(cfg, name)) == _value(getattr(jax_cfg, name)), name
    assert cfg.device is None


def test_missing_inputs_exit_2(tmp_path, capsys):
    assert cli.main(['--prefix', str(tmp_path)]) == 2
    tar, _ = _touch_inputs(tmp_path)
    assert cli.main(['--tar-paths', str(tar), '--prefix', str(tmp_path)]) == 2
    assert 'non-target input' in capsys.readouterr().err


def test_version(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(['--version'])
    assert e.value.code == 0
    assert capsys.readouterr().out.strip() == 'seqwin-tpu-torch v0.1.0'


def _genome_lists(tmp_path, n_tar=3, n_neg=3, length=12_000):
    """Targets from one random root with 0.5% SNPs each, non-targets from an
    8%-diverged root with 1%, each with an N run and cut into two records;
    the path lists."""
    rng = np.random.default_rng(5)
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


# the options that run now: Config fields, CLI flags
OPTIONS = {
    'low_memory': (dict(low_memory=True), ['--low-memory']),
    'numpy': (dict(device_backend='numpy'), ['--backend', 'numpy']),
    'oracle': (dict(device_backend='oracle'), ['--backend', 'oracle']),
}
K_W = dict(kmerlen=15, windowsize=20, min_len=60)
FILES = ('assemblies.csv', 'signatures.fasta', 'signatures.csv')


@pytest.fixture(scope='module')
def jax_run(tmp_path_factory):
    """Inputs and the JAX package's run on them (its host build)."""
    import seqwin_tpu

    tmp = tmp_path_factory.mktemp('options')
    tar, neg = _genome_lists(tmp)
    seqwin_tpu.run(seqwin_tpu.Config(tar_paths=tar, neg_paths=neg, prefix=tmp, title='jax',
                                      run_mash=False, run_blast=False, n_cpu=1,
                                      device_backend='numpy', **K_W))
    assert (tmp / 'jax' / 'signatures.fasta').read_bytes().count(b'>') > 10
    return tar, neg, tmp / 'jax'


@pytest.fixture
def small_low_memory_budget(monkeypatch):
    """A low-memory budget under the record lengths, so they take the
    block path."""
    import importlib

    monkeypatch.setattr(importlib.import_module('seqwin_tpu_torch.graph.build'),
                        'LOW_MEMORY_CHUNK_BASES', 1500)


@pytest.mark.parametrize('case', list(OPTIONS))
def test_run_options_match_jax(tmp_path, jax_run, small_low_memory_budget, case):
    """`run(Config(...))` with low memory or a host backend writes the JAX
    package's files."""
    tar, neg, want = jax_run
    run(Config(tar_paths=tar, neg_paths=neg, prefix=tmp_path, title='port', run_mash=False,
               run_blast=False, n_cpu=1, device='cpu', **K_W, **OPTIONS[case][0]))
    for name in FILES:
        assert (tmp_path / 'port' / name).read_bytes() == (want / name).read_bytes(), name


@pytest.mark.parametrize('case', list(OPTIONS))
def test_cli_options_match_jax(tmp_path, jax_run, small_low_memory_budget, monkeypatch, case):
    """The CLI with ``--low-memory`` or ``--backend numpy|oracle`` exits 0
    with the JAX package's files. The host backends run with no GPU at all;
    the low-memory run is sent to the CPU (the CLI has no device option)."""
    tar, neg, want = jax_run
    if case == 'low_memory':
        to_cpu = cli.config_from_args
        monkeypatch.setattr(cli, 'config_from_args',
                            lambda args: dataclasses.replace(to_cpu(args), device='cpu'))
    rc = cli.main(['--tar-paths', str(tar), '--neg-paths', str(neg), '--prefix', str(tmp_path),
                   '--title', 'port', '--no-mash', '--no-blast', '-p', '1', '-k', '15', '-w', '20',
                   '--min-len', '60',
                   *OPTIONS[case][1]])
    assert rc == 0
    for name in FILES:
        assert (tmp_path / 'port' / name).read_bytes() == (want / name).read_bytes(), name


SEED_PATTERN = '1101100111011'
SKETCH_OPTIONS = {
    'device': ['--sketch-mode', 'device'],
    'device_numpy': ['--sketch-mode', 'device', '--backend', 'numpy'],
    'device_seed_pattern': ['--sketch-mode', 'device', '--seed-pattern', SEED_PATTERN],
}


@pytest.fixture(scope='module')
def jax_sketch_runs(jax_run):
    """The JAX package's runs with the device sketches (its host build), on
    `jax_run`'s inputs, without and with a seed pattern."""
    import seqwin_tpu

    tar, neg, jax_dir = jax_run
    out = {}
    for title, kw in (('jax_sketch', {}), ('jax_sketch_seed', dict(seed_pattern=SEED_PATTERN))):
        seqwin_tpu.run(seqwin_tpu.Config(tar_paths=tar, neg_paths=neg, prefix=jax_dir.parent,
                                          title=title, run_mash=False, run_blast=False, n_cpu=1,
                                          device_backend='numpy', sketch_mode='device',
                                          **K_W, **kw))
        out[title] = jax_dir.parent / title
    return tar, neg, out


@pytest.mark.parametrize('case', list(SKETCH_OPTIONS))
def test_cli_sketch_mode_device_matches_jax(tmp_path, jax_sketch_runs, monkeypatch, case):
    """``--sketch-mode device`` exits 0 with the JAX package's files: on the
    default backend sent to the CPU (the CLI has no device option), and with
    ``--backend numpy`` with no GPU at all (its sketches run on the CPU)."""
    tar, neg, want = jax_sketch_runs
    want = want['jax_sketch_seed' if case == 'device_seed_pattern' else 'jax_sketch']
    if case != 'device_numpy':
        to_cpu = cli.config_from_args
        monkeypatch.setattr(cli, 'config_from_args',
                            lambda args: dataclasses.replace(to_cpu(args), device='cpu'))
    rc = cli.main(['--tar-paths', str(tar), '--neg-paths', str(neg), '--prefix', str(tmp_path),
                   '--title', 'port', '--no-mash', '--no-blast', '-p', '1', '-k', '15', '-w', '20',
                   '--min-len', '60', *SKETCH_OPTIONS[case]])
    assert rc == 0
    for name in FILES:
        assert (tmp_path / 'port' / name).read_bytes() == (want / name).read_bytes(), name


def test_cli_sketch_mode_device_without_gpu_exits_nonzero(tmp_path, jax_sketch_runs, capsys):
    """On the default backend the device sketches need the GPU: without one
    the CLI stops with the CUDA error and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    tar, neg, _ = jax_sketch_runs
    rc = cli.main(['--tar-paths', str(tar), '--neg-paths', str(neg), '--prefix', str(tmp_path),
                   '--title', 'port', '--no-mash', '--no-blast', '--sketch-mode', 'device'])
    assert rc == 1
    assert 'CUDA' in capsys.readouterr().err
    assert not (tmp_path / 'port').exists()
