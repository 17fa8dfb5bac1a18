"""Whole runs of the harness at a CPU size: the result line, the refusal
without a card, and the comparison catching a broken timed path."""
import json

import pytest

from portbench import compare, harness


def _result(capsys, *argv, bench, dev):
    rc = harness.main(['--workload', 'tiny.cli', '--seed', '4294967311', '--seconds', '0.5',
                       *argv], bench=bench, dev=dev)
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else None, out.err


@pytest.mark.parametrize('trace', [0, 1])
def test_last_line(capsys, tiny_bench, on_cpu, trace):
    rc, res, err = _result(capsys, '--trace', str(trace), bench=tiny_bench, dev=on_cpu)
    assert rc == 0
    assert list(res)[:5] == ['correct', 'attempted', 'failed', 'metrics', 'device']
    assert list(res)[-1] == 'compared'
    assert res['correct'] is True and res['failed'] == 0 and res['attempted'] >= 1
    assert {'platform', 'kind', 'count', 'memory_peak_bytes'} <= set(res['device'])
    for m in res['metrics'].values():
        assert set(m) == {'value', 'unit'} and isinstance(m['value'], float | int)
    assert res['compared'] == {n: {'value': 0, 'limit': lim} for n, lim in compare.LIMITS.items()}
    # the numbers compared are the last lines of standard error too
    assert err.strip().splitlines()[-len(compare.LIMITS):] == [
        f"compared {n} {res['compared'][n]['value']} limit {lim}" for n, lim in compare.LIMITS.items()]
    if trace:
        assert {'busy_s', 'window_s'} <= set(res['device'])
        assert set(res['breakdown']) == {'device_ops', 'idle_gaps'}
        assert {'build_graph_s', 'markers_s', 'outside_phases_s'} <= set(res['metrics'])
        assert not set(res['metrics']) & {'job_s', 'setup_s'}
    else:
        assert 'breakdown' not in res
        assert set(res['metrics']) == {'job_s', 'peak_device_gib', 'setup_s'}


class _NoCard:
    def missing(self, chips):
        return 'torch.cuda.is_available() is false'


def test_no_card_no_result(capsys, tiny_bench):
    rc, res, err = _result(capsys, bench=tiny_bench, dev=_NoCard())
    assert rc != 0 and res is None and 'no result' in err


def _unchanged(monkeypatch):
    """A job that returns without doing its work."""
    import seqwin_tpu_torch.core as core
    monkeypatch.setattr(core, 'run', lambda config: None)


def _half_batch(monkeypatch):
    """Every second assembly's records left out of the build."""
    import seqwin_tpu_torch.io.fasta as fasta
    orig = fasta.parse_fasta_codes

    def parse(path):
        ids, codes = orig(path)
        if int(str(path)[-9:-6]) % 2:
            codes = [c[:0] for c in codes]
        return ids, codes

    monkeypatch.setattr(fasta, 'parse_fasta_codes', parse)


def _answer_altered(monkeypatch):
    """One marker's sequence altered where it is fetched."""
    from seqwin_tpu_torch.assemblies import Assemblies
    orig = Assemblies.fetch_seq

    def fetch(self, spans, n_cpu):
        seqs = orig(self, spans, n_cpu)
        seqs[0] = ('C' if seqs[0][0] != 'C' else 'G') + seqs[0][1:]
        return seqs

    monkeypatch.setattr(Assemblies, 'fetch_seq', fetch)


@pytest.mark.parametrize('fault, caught', [
    (_unchanged, {'rows_differing', 'threshold_gap'}),
    (_half_batch, {'rows_differing'}),
    (_answer_altered, {'rows_differing'}),
])
def test_broken_timed_path_is_not_correct(capsys, monkeypatch, tiny_bench, on_cpu, fault, caught):
    fault(monkeypatch)
    rc, res, _ = _result(capsys, bench=tiny_bench, dev=on_cpu)
    assert rc == 0 and res['correct'] is False
    over = {n for n, v in res['compared'].items() if v['value'] > v['limit']}
    assert caught <= over


def test_without_the_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark."""
    import shutil
    import subprocess
    import sys

    from portbench import spec

    shutil.copy(spec.ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(spec.HERE, tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    res = subprocess.run([sys.executable, 'portbench/run.py', '--workload', 's171_cli',
                          '--seed', '1', '--seconds', '1', '--trace', '0'],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ''
    assert 'no result' in res.stderr


@pytest.mark.parametrize('traffic', ['cli', 'cli_low_memory', 'cli_sketch'])
def test_every_traffic_mix_matches_the_reference(capsys, tiny_bench, on_cpu, traffic):
    tiny_bench['workloads'][0]['traffic'] = traffic
    rc, res, _ = _result(capsys, bench=tiny_bench, dev=on_cpu)
    assert rc == 0 and res['correct'] is True, res['compared']
