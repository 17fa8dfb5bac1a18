"""The readers of the program's recorded spans, on synthetic spans and
profiler events, and in a traced run of the harness at a CPU size."""
import json

import pytest

from portbench import harness, spec
from portbench.trace import JOB_SPAN, Event, Job, Run

SPAN_METRICS = ('markers_candidates_s', 'markers_fetch_s', 'pool_overhead_ms', 'worker_cpu_s',
                'ingest_wait_ms', 'host_prep_ms', 'prep_wait_ms', 'block_sync_ms')
MS = 1_000_000  # ns


def _span(name, start_ms, end_ms, **attrs):
    from seqwin_tpu_torch.engine.timeline import Span

    return Span(0, None, 0, name, 1, int(start_ms * MS), int(end_ms * MS), attrs)


def _run(n_jobs):
    """Jobs 1 s long every 2 s from t = 10 s (profiler us)."""
    events = [Event(JOB_SPAN, False, (10 + 2 * j) * 1e6, (11 + 2 * j) * 1e6)
              for j in range(n_jobs)]
    return Run(jobs=[Job(wall_s=1.0, phases={}, counters={}) for _ in range(n_jobs)],
               window_s=2.0 * n_jobs, positions=1, events=events)


def _job(j, *spans):
    """``spans`` (name, start ms, end ms, attrs) shifted into job ``j``."""
    t0 = (10 + 2 * j) * 1000
    return [_span(n, t0 + a, t0 + b, **kw) for n, a, b, kw in spans]


def _read(monkeypatch, run, spans):
    from seqwin_tpu_torch.engine import timeline

    monkeypatch.setattr(timeline, 'spans', lambda: list(spans))
    return {m: spec.module('metrics', m).read(run) for m in SPAN_METRICS}


# one job of the chunked build (s171_cli) and one of the block path (s171c_lowmem)
CHUNKED = (('markers.candidates', 100, 400, {}), ('markers.fetch_seq', 400, 500, {}),
           ('pool.start', 100, 120, {}), ('pool.stop', 380, 390, {'child_cpu_s': 1.5}),
           ('pool.start', 400, 405, {}), ('pool.stop', 495, 500, {'child_cpu_s': 0.5}),
           ('build.ingest_wait', 10, 30, {}), ('hybrid.host_prep', 20, 60, {}),
           ('hybrid.host_prep', 25, 45, {}), ('build.prep_wait', 60, 62, {}))
BLOCKS = tuple(s for s in CHUNKED if s[0] != 'build.prep_wait') + (
    ('block.sync', 70, 71, {}), ('block.sync', 72, 75, {}))


def test_values_are_per_job(monkeypatch):
    got = _read(monkeypatch, _run(2), _job(0, *CHUNKED) + _job(1, *CHUNKED))
    assert got == pytest.approx({
        'markers_candidates_s': 0.3, 'markers_fetch_s': 0.1, 'pool_overhead_ms': 40.0,
        'worker_cpu_s': 2.0, 'ingest_wait_ms': 20.0, 'host_prep_ms': 60.0,
        'prep_wait_ms': 2.0, 'block_sync_ms': None})
    # spans of one job only still read per job of the window
    assert _read(monkeypatch, _run(2), _job(1, *CHUNKED))['host_prep_ms'] == pytest.approx(30.0)


def test_windowing_drops_spans_outside_the_jobs(monkeypatch):
    inside = _job(0, *BLOCKS)
    warmup = [_span(n, 5000 + a, 5000 + b, **kw) for n, a, b, kw in BLOCKS]  # before the window
    across = [_span('block.sync', 10_900, 11_100)]  # over the job's end
    after = _job(1, *BLOCKS)  # a job the profiler holds no span of
    got = _read(monkeypatch, _run(1), warmup + inside + across + after)
    assert got == _read(monkeypatch, _run(1), inside)
    assert got['block_sync_ms'] == pytest.approx(4.0) and got['prep_wait_ms'] is None


def test_none_where_absent(monkeypatch):
    assert set(_read(monkeypatch, _run(2), []).values()) == {None}
    assert set(_read(monkeypatch, _run(1), [_span('other', 10_100, 10_200)]).values()) == {None}
    untraced = _run(1)
    untraced.events = None
    assert set(_read(monkeypatch, untraced, _job(0, *CHUNKED)).values()) == {None}
    # a pool.stop without the counter (the recorder on after the pool started)
    got = _read(monkeypatch, _run(1), _job(0, ('pool.stop', 1, 2, {})))
    assert got['worker_cpu_s'] is None and got['pool_overhead_ms'] == pytest.approx(1.0)


def test_program_without_a_span_recorder(monkeypatch):
    """The parent's program: its timeline has no `spans()`."""
    from seqwin_tpu_torch.engine import timeline

    monkeypatch.delattr(timeline, 'spans')
    assert {spec.module('metrics', m).read(_run(1)) for m in SPAN_METRICS} == {None}


def test_cells_of_each_reader():
    bench = spec.benchmark()
    cli = {m['name'] for m in spec.metrics(bench, 's171_cli', 'per_layer')}
    low = {m['name'] for m in spec.metrics(bench, 's171c_lowmem', 'per_layer')}
    assert set(SPAN_METRICS) - {'block_sync_ms'} <= cli and 'block_sync_ms' not in cli
    assert set(SPAN_METRICS) - {'prep_wait_ms'} <= low and 'prep_wait_ms' not in low


@pytest.mark.parametrize('traffic', ['cli', 'cli_low_memory'])
def test_traced_run_reports_the_span_metrics(capsys, monkeypatch, tiny_bench, on_cpu, traffic):
    import importlib
    import time

    from seqwin_tpu_torch.engine import timeline

    # the chunk's prep slowed, so the main thread waits on it
    # (`build.prep_wait`) however the threads are scheduled
    build_mod = importlib.import_module('seqwin_tpu_torch.graph.build')
    prep = build_mod.pinned_host_prep
    monkeypatch.setattr(build_mod, 'pinned_host_prep',
                        lambda *args: (time.sleep(0.2), prep(*args))[1])
    timeline.reset()
    tiny_bench['workloads'][0]['traffic'] = traffic
    tiny_bench['per_layer'] += [{'name': n, 'unit': 'ms'} for n in SPAN_METRICS]
    rc = harness.main(['--workload', 'tiny.cli', '--seed', '4294967311', '--seconds', '0.5',
                       '--trace', '1'], bench=tiny_bench, dev=on_cpu)
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res['correct'] is True
    # the tiny genomes' records fit a chunk: no block path
    assert set(res['metrics']) & set(SPAN_METRICS) == set(SPAN_METRICS) - {'block_sync_ms'}
    assert res['metrics']['worker_cpu_s']['value'] > 0
