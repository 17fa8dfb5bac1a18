"""seqwin_tpu_torch's Config and CLI against the JAX package's: the same
validation (exception types and messages), the same `config.json`, the
same option surface, the same Config from the same command line; the
options the port does not have yet stop with their ROADMAP item."""
import argparse
import dataclasses
import json
import pickle
from enum import Enum

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


UNPORTED = {
    'low_memory': (dict(low_memory=True), ['--low-memory'], 'A8'),
    'numpy': (dict(device_backend='numpy'), ['--backend', 'numpy'], 'A10'),
    'oracle': (dict(device_backend='oracle'), ['--backend', 'oracle'], 'A10'),
    'sketch_device': (dict(sketch_mode='device'), ['--sketch-mode', 'device'], 'A12'),
}


@pytest.fixture
def fasta_lists(tmp_path):
    paths = []
    for i in range(2):
        p = tmp_path / f'g{i}.fa'
        p.write_text(f'>r{i}\n' + 'ACGTTGCA' * 40 + '\n')
        paths.append(p)
    tar, neg = tmp_path / 'tar.txt', tmp_path / 'neg.txt'
    tar.write_text(f'{paths[0]}\n')
    neg.write_text(f'{paths[1]}\n')
    return tar, neg


@pytest.mark.parametrize('case', list(UNPORTED))
def test_unported_options_raise(tmp_path, fasta_lists, case):
    kwargs, _, item = UNPORTED[case]
    tar, neg = fasta_lists
    with pytest.raises(NotImplementedError, match=item):
        run(Config(tar_paths=tar, neg_paths=neg, prefix=tmp_path, run_mash=False,
                   run_blast=False, device='cpu', **kwargs))


@pytest.mark.parametrize('case', list(UNPORTED))
def test_unported_options_exit_nonzero(tmp_path, fasta_lists, monkeypatch, capsys, case):
    """On the CLI the NotImplementedError becomes a message and exit code 1
    (the GPU check is passed here so the run reaches the build)."""
    _, flags, item = UNPORTED[case]
    tar, neg = fasta_lists
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    rc = cli.main(['--tar-paths', str(tar), '--neg-paths', str(neg), '--prefix', str(tmp_path),
                   '--no-mash', '--no-blast', *flags])
    assert rc == 1
    assert item in capsys.readouterr().err
