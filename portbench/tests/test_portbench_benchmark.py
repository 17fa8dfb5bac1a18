"""`BENCHMARK.json` against the benchmark's contract, and every file it
names."""
import json
import re

import pytest

from portbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_top_level():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                          'end_to_end', 'per_layer'}
    assert BENCH['command'] == ['python3', 'portbench/run.py']
    assert all(PATH.match(p) and not p.startswith('/') and '..' not in p for p in BENCH['paths'])
    assert isinstance(BENCH['run_seconds'], int) and 1 <= BENCH['run_seconds'] <= 51
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (BENCH['run_seconds'] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_configs():
    names = [c['name'] for c in BENCH['configs']]
    assert len(set(names)) == len(names)
    used = {w['config'] for w in BENCH['workloads']}
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert NAME.match(c['name']) and c['name'] in used
        assert _line(c['source']) and _line(c['why']) and c['source'].startswith('https://')
        assert c['file'].startswith('portbench/configs/')
        data = json.loads((spec.ROOT / c['file']).read_text())
        assert data['name'] == c['name'] and data['reduced'] == c['reduced']
        assert (spec.HERE / 'datagen' / f"{data['generator']}.py").is_file()


def test_workloads():
    names = [w['name'] for w in BENCH['workloads']]
    pairs = [(w['config'], w['traffic']) for w in BENCH['workloads']]
    assert len(set(names)) == len(names) and len(set(pairs)) == len(pairs)
    assert sum(w['chips'] == 4 for w in BENCH['workloads']) <= max(1, len(names) // 4)
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert NAME.match(w['name']) and NAME.match(w['traffic']) and w['chips'] in (1, 4)
        assert _line(w['why'])
        assert (spec.HERE / 'traffic' / f"{w['traffic']}.json").is_file()


@pytest.mark.parametrize('kind', ['end_to_end', 'per_layer'])
def test_metrics(kind):
    e2e = {m['name'] for m in BENCH['end_to_end']}
    cells = {w['name'] for w in BENCH['workloads']}
    for m in BENCH[kind]:
        assert NAME.match(m['name']) and UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
        assert set(m.get('workloads', [])) <= cells
        reader = spec.HERE / ('end_to_end' if kind == 'end_to_end' else 'metrics') / f"{m['name']}.py"
        assert reader.is_file()
        if kind == 'end_to_end':
            assert set(m) <= {'name', 'unit', 'better', 'bound', 'source', 'workloads'}
            assert m['source'] in ('host_clock', 'device_trace')
            assert 0.01 <= m['bound'] <= 0.25
        else:
            assert set(m) <= {'name', 'unit', 'better', 'source', 'layer', 'moves', 'workloads'}
            assert m['source'] in ('device_trace', 'program_span', 'program_counter', 'host_clock')
            assert m['moves'] in e2e and _line(m['layer'])
    if kind == 'end_to_end':
        assert 'setup_s' in e2e and len(e2e) >= 2
    names = [m['name'] for k in ('end_to_end', 'per_layer') for m in BENCH[k]]
    assert len(set(names)) == len(names)
