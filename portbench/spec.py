"""Everything the harness reads by name: `BENCHMARK.json` at the root of the
checkout, and under `portbench/` each configuration (its file), traffic mix
(``traffic/<name>.json``), data generator (``datagen/<name>.py``) and
per-layer metric reader (``metrics/<name>.py``). A new cell, mix or metric
is a new file and a new entry; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / 'BENCHMARK.json').read_text())


def cell(bench: dict, name: str) -> dict:
    """The cell's workload entry, with its configuration and traffic files
    read: ``config`` and ``traffic`` become their contents."""
    entry = next((w for w in bench['workloads'] if w['name'] == name), None)
    if entry is None:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json')
    conf = next(c for c in bench['configs'] if c['name'] == entry['config'])
    return dict(entry, config=json.loads((ROOT / conf['file']).read_text()),
                traffic=json.loads((HERE / 'traffic' / f"{entry['traffic']}.json").read_text()))


def metrics(bench: dict, cell_name: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` entries a cell reports."""
    return [m for m in bench[kind] if cell_name in m.get('workloads', [cell_name])]


def module(kind: str, name: str):
    """``portbench/<kind>/<name>.py``, loaded by its path."""
    path = HERE / kind / f'{name}.py'
    spec = importlib.util.spec_from_file_location(f'portbench.{kind}.{name}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
