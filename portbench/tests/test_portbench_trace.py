"""The trace reductions and each per-layer reader, on synthetic events."""
import pytest

from portbench import peaks, spec
from portbench.trace import (JOB_SPAN, Event, Job, Run, device_busy_us, idle_gaps, merged,
                             top_device_ops)

B1 = 'void (anonymous namespace)::phase1_kernel<0>(unsigned char const*, long long, int)'


def _run(events, jobs=2, window_s=1.0, positions=1 << 25, **job):
    return Run(jobs=[Job(wall_s=5.0, phases=dict(build_graph=1.0, threshold=0.1, subgraphs=0.4,
                                                 markers=3.0), counters={'b1_launches': 25}, **job)
                     for _ in range(jobs)],
               window_s=window_s, positions=positions, events=events)


def test_union_of_overlapping_intervals():
    assert merged([(5, 9), (0, 2), (1, 3), (8, 12), (20, 21)]) == [(0, 3), (5, 12), (20, 21)]
    events = [Event('k1', True, 0, 10), Event('copy', True, 5, 15), Event('k2', True, 30, 40),
              Event('host op', False, 0, 100)]
    assert device_busy_us(events) == 25


def test_b1_bound_at_2_25_positions():
    assert peaks.b1_bound_s(1 << 25) * 1e3 == pytest.approx(0.1003, abs=5e-5)
    # bound by instructions: the byte bound is shorter
    assert 5 * (1 << 25) / peaks.HBM_BYTES_PER_S < peaks.b1_bound_s(1 << 25)


def test_b1_roofline_and_launches():
    # two jobs of one 2^25 chunk each, B1 0.38 ms a launch
    events = [Event(B1, True, i * 1000.0, i * 1000.0 + 380.0) for i in range(2)]
    run = _run(events)
    pct = spec.module('metrics', 'b1_roofline_pct').read(run)
    assert pct == pytest.approx(100 * 0.1003 / 0.38, rel=1e-3)
    assert spec.module('metrics', 'b1_launches').read(run) == 25
    assert spec.module('metrics', 'b1_roofline_pct').read(_run([Event('other', True, 0, 1)])) is None
    assert spec.module('metrics', 'b1_launches').read(_run([], jobs=1, )) == 25


def test_device_idle_and_host_spans():
    events = [Event('k', True, 0, 100_000), Event('k', True, 50_000, 250_000),
              Event('build.aggregate', False, 0, 30_000), Event('build.aggregate', False, 0, 10_000)]
    run = _run(events, jobs=2, window_s=1.0)
    assert spec.module('metrics', 'device_idle_pct').read(run) == pytest.approx(75.0)
    assert spec.module('metrics', 'aggregate_ms').read(run) == pytest.approx(20.0)
    assert spec.module('metrics', 'aggregate_ms').read(_run([Event('k', True, 0, 1)])) is None


def test_phase_readers():
    run = _run([])
    want = {'build_graph_s': 1.0, 'threshold_s': 0.1, 'subgraphs_s': 0.4, 'markers_s': 3.0,
            'outside_phases_s': 0.5}
    for name, value in want.items():
        assert spec.module('metrics', name).read(run) == pytest.approx(value)
    run.jobs[0].phases.pop('markers')
    assert spec.module('metrics', 'markers_s').read(run) is None
    assert spec.module('metrics', 'outside_phases_s').read(run) is None


def test_breakdown():
    marks = [('INFO', 'Building minimizer graph from 2 assemblies...', 1.0),
             ('INFO', ' - Finished in 0:00:01.300000', 2.3),
             ('INFO', 'Finding a representative for each low-penalty subgraph...', 2.3),
             ('INFO', ' - Finished in 0:00:01.650000', 3.95)]
    events = [Event(JOB_SPAN, False, 10e6, 13e6), Event('k', True, 11.2e6, 11.3e6),
              Event('k2', True, 11.25e6, 11.5e6), Event('k', True, 12.9e6, 12.95e6)]
    run = _run(events, jobs=1, log_marks=marks)
    run.clock_offset_us = 9e6  # profiler time 10 s is host time 1 s
    gaps = idle_gaps(run)
    assert [name for name, _ in gaps] == ['markers', 'build_graph', 'outside phases']
    assert [s for _, s in gaps] == pytest.approx([1.4, 1.2, 0.05])
    assert top_device_ops(events) == [['k2', pytest.approx(0.25)], ['k', pytest.approx(0.15)]]
