"""What a run records for the per-layer metrics, and the reductions of a
device trace.

A traced window runs under the harness's own `torch.profiler` (CPU and CUDA
activities), read in memory: nothing is exported. Its events become plain
`Event` tuples, so the reductions below (and the metric readers) take
synthetic events as well:
- device busy is the union of the device intervals (kernels, copies,
  sets), not a sum, so work that overlaps on several streams counts once;
  the profiler's own rows ("Activity Buffer Request") and device-side
  mirrors of host annotations are no work;
- an idle gap is a stretch of the window with no device interval, named by
  what the job was doing on the host then: its pipeline phase (the
  program's log headings, `phases.timed`, stamped by the harness as the
  program logs them) or "outside phases".
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import NamedTuple

from .phases import timed

PROFILER_ROWS = frozenset(('Activity Buffer Request',))
JOB_SPAN = 'portbench.job'


class Event(NamedTuple):
    name: str
    device: bool       # ran on the device (a kernel, copy or set)
    start_us: float
    end_us: float


@dataclass
class Job:
    wall_s: float
    phases: dict                 # phase -> seconds, from the job's log
    counters: dict               # program counters, this job's increments
    log_marks: list = field(default_factory=list)  # (level, message, host s), traced runs
    start_s: float = 0.0         # host clock at the job's start


@dataclass
class Run:
    """One run's window; with ``--trace 1`` also the profiler's events."""
    jobs: list
    window_s: float
    positions: int               # bases of the input's records (one job)
    setup_s: float = 0.0
    peak_bytes: int = 0          # device memory allocated at most in the window
    events: list | None = None   # Event, traced runs only
    clock_offset_us: float = 0.0  # profiler us minus host us


def from_profiler(prof) -> list[Event]:
    """The device events and host spans (`record_function` annotations) of
    a stopped profiler, read from its raw results: building torch's
    `FunctionEvent` tree for a window of low-memory jobs took minutes and
    ~10 GB. Host operator events are not kept; device rows that are no work
    are left out."""
    from torch.autograd import DeviceType

    raw = prof.profiler.kineto_results.events()
    spans = {e.name() for e in raw if e.device_type() == DeviceType.CPU and e.is_user_annotation()}
    out = []
    for e in raw:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if e.is_user_annotation():
                out.append(Event(name, False, e.start_ns() / 1e3, e.end_ns() / 1e3))
        elif not (name in PROFILER_ROWS or name in spans or e.is_user_annotation()):
            out.append(Event(name, True, e.start_ns() / 1e3, e.end_ns() / 1e3))
    return out


def merged(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, as disjoint sorted intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def device_busy_us(events) -> float:
    return sum(e - s for s, e in merged((ev.start_us, ev.end_us) for ev in events if ev.device))


def device_time_us(events, name_part: str) -> tuple[float, int]:
    """(summed time, count) of the device events whose name holds
    ``name_part``."""
    hits = [ev.end_us - ev.start_us for ev in events if ev.device and name_part in ev.name]
    return sum(hits), len(hits)


def span_time_us(events, name: str) -> tuple[float, int]:
    """(summed time, count) of the host spans named ``name``."""
    hits = [ev.end_us - ev.start_us for ev in events if not ev.device and ev.name == name]
    return sum(hits), len(hits)


def top_device_ops(events, n: int = 10) -> list[list]:
    total: dict[str, float] = defaultdict(float)
    for ev in events:
        if ev.device:
            total[ev.name] += ev.end_us - ev.start_us
    return [[name, us / 1e6] for name, us in sorted(total.items(), key=lambda x: -x[1])[:n]]


def phase_spans(jobs) -> list[tuple[float, float, str]]:
    """(host start s, host end s, phase) of every timed phase of the jobs."""
    return [(a, b, name) for job in jobs for name, a, b, _ in timed(job.log_marks)]


def idle_gaps(run: Run, n: int = 10) -> list[list]:
    """The ``n`` longest idle stretches of the traced window inside jobs,
    each named by the phase its middle falls in."""
    busy = merged((ev.start_us, ev.end_us) for ev in run.events if ev.device)
    jobs = [(ev.start_us, ev.end_us) for ev in run.events if not ev.device and ev.name == JOB_SPAN]
    gaps = []
    for js, je in jobs:
        t = js
        for s, e in busy:
            if e <= js or s >= je:
                continue
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if je > t:
            gaps.append((t, je))
    spans = phase_spans(run.jobs)
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
        mid_host = ((s + e) / 2 - run.clock_offset_us) / 1e6
        name = next((p for a, b, p in spans if a <= mid_host <= b), 'outside phases')
        out.append([name, (e - s) / 1e6])
    return out
