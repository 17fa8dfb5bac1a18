"""The readers of the irregular-window patches' span, `patches_ms` and
`patch_ranks`: on synthetic spans, where the program records none (as a
program before the span does), and in a traced run of the harness on a
CPU-sized contig set."""
import json

import pytest

from portbench import harness, spec
from portbench.trace import JOB_SPAN, Event, Job, Run

METRICS = ('patches_ms', 'patch_ranks')
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
    return {m: spec.module('metrics', m).read(run) for m in METRICS}


# one job's build: two chunks prepped in two threads, each with its patches
CHUNKS = (('hybrid.host_prep', 100, 160, {}),
          ('hybrid.patches', 110, 150, {'records': 500, 'windows': 900, 'ranks': 100_000}),
          ('hybrid.host_prep', 120, 200, {}),
          ('hybrid.patches', 125, 185, {'records': 700, 'windows': 1_100, 'ranks': 140_000}))


def test_values_are_per_job_summed_over_threads(monkeypatch):
    got = _read(monkeypatch, _run(2), _job(0, *CHUNKS) + _job(1, *CHUNKS))
    assert got == pytest.approx({'patches_ms': 100.0, 'patch_ranks': 240_000})
    # one job's spans over two jobs of the window
    got = _read(monkeypatch, _run(2), _job(1, *CHUNKS))
    assert got == pytest.approx({'patches_ms': 50.0, 'patch_ranks': 120_000})


def test_spans_outside_the_jobs_do_not_count(monkeypatch):
    # the warm-up job's spans (before the window) and a span across a job's end
    spans = ([_span('hybrid.patches', 1_000, 1_050, ranks=7)]
             + _job(0, ('hybrid.patches', 990, 1_010, {'ranks': 9}), *CHUNKS))
    assert _read(monkeypatch, _run(1), spans) == pytest.approx(
        {'patches_ms': 100.0, 'patch_ranks': 240_000})


@pytest.mark.parametrize('spans', [
    [],  # a program before the span: its host prep has no patches span
    _job(0, ('hybrid.host_prep', 100, 160, {})),
], ids=['no_spans', 'host_prep_only'])
def test_nothing_where_the_program_records_no_patches(monkeypatch, spans):
    assert _read(monkeypatch, _run(1), spans) == {m: None for m in METRICS}


def test_nothing_without_a_recorder(monkeypatch):
    from seqwin_tpu_torch.engine import timeline

    monkeypatch.delattr(timeline, 'spans')
    assert {m: spec.module('metrics', m).read(_run(1)) for m in METRICS} == {
        m: None for m in METRICS}


def test_nothing_in_an_untraced_run(monkeypatch):
    run = _run(1)
    run.events = []
    assert _read(monkeypatch, run, _job(0, *CHUNKS)) == {m: None for m in METRICS}


def test_traced_contig_run_reports_both(capsys, tmp_path, tiny_bench, on_cpu):
    """A traced CPU run of the harness on a contig set of the configuration's
    generator at a small size: both metrics read, and the patches hash at
    least w ranks at every record head."""
    from seqwin_tpu_torch.engine import timeline

    config = json.loads((spec.ROOT / 'portbench' / 'configs' / 'salmonella171_contigs.json')
                        .read_text())
    config['generator_params'].update(n_tar=4, n_neg=6, genome_len=60_000,
                                      contigs_per_genome=[5, 20], contig_len=[300, 30_000])
    path = tmp_path / 'tiny_contigs.json'
    path.write_text(json.dumps(config))
    tiny_bench['configs'][0]['file'] = str(path)
    tiny_bench['per_layer'] += [{'name': n, 'unit': 'ms'} for n in METRICS]
    timeline.reset()
    rc = harness.main(['--workload', 'tiny.cli', '--seed', '4294967311', '--seconds', '0.5',
                       '--trace', '1'], bench=tiny_bench, dev=on_cpu)
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res['correct'] is True
    assert set(METRICS) <= set(res['metrics'])
    assert res['metrics']['patches_ms']['value'] > 0
    # at least 50 records a job, each head hashing w ranks or more
    assert res['metrics']['patch_ranks']['value'] >= 50 * config['windowsize']
