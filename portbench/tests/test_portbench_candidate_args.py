"""The reader of `candidate_args_ms` (the program's span
`markers.candidate_args`), on synthetic spans and profiler events, and in a
traced run of the harness at a CPU size."""
import json

import pytest

from portbench import harness, spec
from portbench.trace import JOB_SPAN, Event, Job, Run

MS = 1_000_000  # ns


def _read(monkeypatch, run, spans):
    from seqwin_tpu_torch.engine import timeline

    monkeypatch.setattr(timeline, 'spans', lambda: list(spans))
    return spec.module('metrics', 'candidate_args_ms').read(run)


def _run(n_jobs):
    """Jobs 1 s long every 2 s from t = 10 s (profiler us)."""
    events = [Event(JOB_SPAN, False, (10 + 2 * j) * 1e6, (11 + 2 * j) * 1e6)
              for j in range(n_jobs)]
    return Run(jobs=[Job(wall_s=1.0, phases={}, counters={}) for _ in range(n_jobs)],
               window_s=2.0 * n_jobs, positions=1, events=events)


def _spans(j, *spans):
    """``spans`` (name, start ms, end ms, attrs) shifted into job ``j``."""
    from seqwin_tpu_torch.engine.timeline import Span

    t0 = (10 + 2 * j) * 1000
    return [Span(0, None, 0, n, 1, int((t0 + a) * MS), int((t0 + b) * MS), kw)
            for n, a, b, kw in spans]


# one job's markers phase: the arguments inside the candidates, then the fetch
JOB = (('markers.candidates', 100, 400, {'subgraphs': 300}),
       ('markers.candidate_args', 100, 125, {'nodes': 1055, 'graph_nodes': 87833}),
       ('pool.start', 125, 140, {}), ('markers.fetch_seq', 400, 500, {}))


def test_value_is_per_job(monkeypatch):
    assert _read(monkeypatch, _run(2), _spans(0, *JOB) + _spans(1, *JOB)) == pytest.approx(25.0)
    # a job's span alone still reads per job of the window
    assert _read(monkeypatch, _run(2), _spans(1, *JOB)) == pytest.approx(12.5)
    # the parent's span carries no attributes: read all the same
    bare = tuple((n, a, b, {}) for n, a, b, _ in JOB)
    assert _read(monkeypatch, _run(1), _spans(0, *bare)) == pytest.approx(25.0)


def test_windowing_drops_spans_outside_the_jobs(monkeypatch):
    warmup = [s._replace(start_ns=s.start_ns - 5000 * MS, end_ns=s.end_ns - 5000 * MS)
              for s in _spans(0, *JOB)]
    across = _spans(0, ('markers.candidate_args', 990, 1010, {}))  # over the job's end
    got = _read(monkeypatch, _run(1), warmup + _spans(0, *JOB) + across)
    assert got == pytest.approx(25.0)


def test_none_where_absent(monkeypatch):
    assert _read(monkeypatch, _run(2), []) is None
    others = tuple(s for s in JOB if s[0] != 'markers.candidate_args')
    assert _read(monkeypatch, _run(1), _spans(0, *others)) is None
    untraced = _run(1)
    untraced.events = None
    assert _read(monkeypatch, untraced, _spans(0, *JOB)) is None


def test_program_without_a_span_recorder(monkeypatch):
    from seqwin_tpu_torch.engine import timeline

    monkeypatch.delattr(timeline, 'spans')
    assert spec.module('metrics', 'candidate_args_ms').read(_run(1)) is None


def test_both_cells_report_it():
    bench = spec.benchmark()
    (entry,) = [m for m in bench['per_layer'] if m['name'] == 'candidate_args_ms']
    assert entry['layer'] == 'markers' and entry['moves'] == 'job_s'
    for cell in ('s171_cli', 's171c_lowmem'):
        assert 'candidate_args_ms' in {m['name'] for m in spec.metrics(bench, cell, 'per_layer')}


def test_traced_run_reports_candidate_args(capsys, tiny_bench, on_cpu):
    from seqwin_tpu_torch.engine import timeline

    timeline.reset()
    tiny_bench['per_layer'] += [{'name': 'candidate_args_ms', 'unit': 'ms'},
                                {'name': 'markers_candidates_s', 'unit': 's'}]
    rc = harness.main(['--workload', 'tiny.cli', '--seed', '4294967311', '--seconds', '0.5',
                       '--trace', '1'], bench=tiny_bench, dev=on_cpu)
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res['correct'] is True
    args_ms = res['metrics']['candidate_args_ms']['value']
    assert 0 < args_ms <= 1e3 * res['metrics']['markers_candidates_s']['value']
