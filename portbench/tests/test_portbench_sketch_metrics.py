"""The readers of the device sketches' spans and roofline, on synthetic spans
and device events, and in a traced run of the harness at a CPU size."""
import json

import pytest

from portbench import harness, sketch_peaks, spec
from portbench.trace import JOB_SPAN, Event, Job, Run

SKETCH_METRICS = ('sketches_s', 'sketch_join_ms', 'jaccard_ms', 'sketch_roofline_pct')
MS = 1_000_000  # ns
POSITIONS = 803_700_000  # bases of the 171-assembly set


def _span(name, start_ms, end_ms, **attrs):
    from seqwin_tpu_torch.engine.timeline import Span

    return Span(0, None, 0, name, 1, int(start_ms * MS), int(end_ms * MS), attrs)


def _run(n_jobs, device=()):
    """Jobs 1 s long every 2 s from t = 10 s (profiler us); ``device`` is
    (start ms, end ms) of device events."""
    events = [Event(JOB_SPAN, False, (10 + 2 * j) * 1e6, (11 + 2 * j) * 1e6)
              for j in range(n_jobs)]
    events += [Event('kernel', True, a * 1e3, b * 1e3) for a, b in device]
    return Run(jobs=[Job(wall_s=1.0, phases={}, counters={}) for _ in range(n_jobs)],
               window_s=2.0 * n_jobs, positions=POSITIONS, events=events)


def _job(j, *spans):
    """``spans`` (name, start ms, end ms) shifted into job ``j``."""
    t0 = (10 + 2 * j) * 1000
    return [_span(n, t0 + a, t0 + b) for n, a, b in spans]


def _read(monkeypatch, run, spans):
    from seqwin_tpu_torch.engine import timeline

    monkeypatch.setattr(timeline, 'spans', lambda: list(spans))
    return {m: spec.module('metrics', m).read(run) for m in SKETCH_METRICS}


# one job's threshold phase: three assemblies, then the matrix
SKETCH = (('threshold.sketches', 100, 400), ('sketch.join', 100, 120), ('sketch.fetch', 150, 200),
          ('sketch.join', 200, 230), ('sketch.fetch', 240, 300), ('sketch.join', 300, 310),
          ('sketch.fetch', 320, 400), ('threshold.jaccard', 400, 430))


def test_bound_of_the_171_assemblies():
    # 34 instructions a position bound it: 1.63 ms over 803.7 Mbp
    assert sketch_peaks.sketch_bound_s(POSITIONS) * 1e3 == pytest.approx(1.6336, abs=1e-4)
    assert POSITIONS / sketch_peaks.HBM_BYTES_PER_S < sketch_peaks.sketch_bound_s(POSITIONS)


def test_span_values_are_per_job(monkeypatch):
    got = _read(monkeypatch, _run(2), _job(0, *SKETCH) + _job(1, *SKETCH))
    assert got == pytest.approx({'sketches_s': 0.3, 'sketch_join_ms': 60.0, 'jaccard_ms': 30.0,
                                 'sketch_roofline_pct': None})
    assert _read(monkeypatch, _run(2), _job(1, *SKETCH))['jaccard_ms'] == pytest.approx(15.0)


@pytest.mark.parametrize('device, busy_ms', [
    ([(10_150, 10_160)], 10),
    # an h2d copy and a kernel on two streams overlap: counted once
    ([(10_150, 10_160), (10_155, 10_170)], 20),
    # work before, after and across the span's ends is cut to the span
    ([(10_050, 10_090), (10_090, 10_110), (10_390, 10_420), (10_450, 10_460)], 20),
    # the matrix and the other phases are not the sketches' work
    ([(10_150, 10_152), (10_400, 10_430), (10_500, 10_900)], 2),
])
def test_roofline_counts_device_time_inside_the_sketch_spans_once(monkeypatch, device, busy_ms):
    pct = _read(monkeypatch, _run(1, device), _job(0, *SKETCH))['sketch_roofline_pct']
    assert pct == pytest.approx(100 * sketch_peaks.sketch_bound_s(POSITIONS) / (busy_ms / 1e3))


def test_roofline_over_jobs(monkeypatch):
    # two jobs, 10 and 30 ms of device work in their sketches: two bounds over 40 ms
    run = _run(2, [(10_150, 10_160), (12_150, 12_180)])
    pct = _read(monkeypatch, run, _job(0, *SKETCH) + _job(1, *SKETCH))['sketch_roofline_pct']
    assert pct == pytest.approx(100 * 2 * sketch_peaks.sketch_bound_s(POSITIONS) / 0.040)
    # a sketch span outside the jobs (the warm-up job) counts neither its bound nor its work
    warmup = [_span('threshold.sketches', 5_000, 5_300)]
    run = _run(1, [(5_100, 5_200), (10_150, 10_160)])
    pct = _read(monkeypatch, run, warmup + _job(0, *SKETCH))['sketch_roofline_pct']
    assert pct == pytest.approx(100 * sketch_peaks.sketch_bound_s(POSITIONS) / 0.010)


def test_nothing_where_no_sketch_span_was_recorded(monkeypatch):
    """The parent's program records none of these spans (nor does a
    ``--no-mash`` job); an untraced run holds no events."""
    other = _job(0, ('phase.threshold', 0, 500), ('build', 500, 600))
    assert set(_read(monkeypatch, _run(1, [(10_100, 10_200)]), other).values()) == {None}
    untraced = _run(1)
    untraced.events = None
    assert set(_read(monkeypatch, untraced, _job(0, *SKETCH)).values()) == {None}


def test_program_without_a_span_recorder(monkeypatch):
    from seqwin_tpu_torch.engine import timeline

    monkeypatch.delattr(timeline, 'spans')
    run = _run(1, [(10_150, 10_160)])
    assert {spec.module('metrics', m).read(run) for m in SKETCH_METRICS} == {None}


def test_the_sketch_cell_reports_them():
    bench = spec.benchmark()
    assert set(SKETCH_METRICS) <= {m['name'] for m in spec.metrics(bench, 's171_sketch', 'per_layer')}
    for cell in ('s171_cli', 's171c_lowmem'):
        assert not set(SKETCH_METRICS) & {m['name'] for m in spec.metrics(bench, cell, 'per_layer')}
    sketch = spec.cell(bench, 's171_sketch')
    assert sketch['traffic']['argv'][:2] == ['--sketch-mode', 'device']
    assert sketch['config']['name'] == 'salmonella171_mash'


def test_the_sketch_configuration_is_s171_cli_s_genomes_at_mash_s_defaults():
    """`salmonella171_mash` makes the genomes of `salmonella171` at the same
    k and w, so `s171_cli` is its control; its sketch size is the one the
    port's CLI and the reference use."""
    import dataclasses

    from portbench.reference.pipeline import SKETCH_SIZE
    from seqwin_tpu_torch.config import Config

    cli_default = next(f.default for f in dataclasses.fields(Config) if f.name == 'sketchsize')
    bench = spec.benchmark()
    mash_cfg = spec.cell(bench, 's171_sketch')['config']
    cli_cfg = spec.cell(bench, 's171_cli')['config']
    for key in ('kmerlen', 'windowsize', 'generator', 'generator_params', 'precision', 'reference'):
        assert mash_cfg[key] == cli_cfg[key], key
    assert mash_cfg['sketchsize'] == SKETCH_SIZE == cli_default == 1000
    entries = {c['name']: c for c in bench['configs']}
    assert entries['salmonella171_mash']['source'] != entries['salmonella171']['source']


def test_traced_run_reports_the_sketch_span_metrics(capsys, tiny_bench, on_cpu):
    from seqwin_tpu_torch.engine import timeline

    timeline.reset()
    tiny_bench['workloads'][0]['traffic'] = 'cli_sketch'
    tiny_bench['per_layer'] += [{'name': n, 'unit': 'ms'} for n in SKETCH_METRICS]
    rc = harness.main(['--workload', 'tiny.cli', '--seed', '4294967329', '--seconds', '0.5',
                       '--trace', '1'], bench=tiny_bench, dev=on_cpu)
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res['correct'] is True
    # the CPU stand-in traces no device: no roofline
    assert set(res['metrics']) & set(SKETCH_METRICS) == set(SKETCH_METRICS) - {'sketch_roofline_pct'}
    assert 0 < res['metrics']['sketch_join_ms']['value'] < 1e3 * res['metrics']['sketches_s']['value']
