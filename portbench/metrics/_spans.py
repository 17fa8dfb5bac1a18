"""Helpers of the readers of the program's own spans: the recorder
`seqwin_tpu_torch.engine.timeline` (on in traced runs) keeps them, stamped
with `time.time_ns()`, the clock of the profiler's events, and they are read
after the window. A span counts when it lies inside one of the harness's
`JOB_SPAN` spans in the profiler's events, so the warm-up job and anything
outside the window drop out with no clock offset. A checkout whose program
records no spans gives nothing."""
from __future__ import annotations

from portbench.trace import JOB_SPAN


def recorded():
    """The program's recorded spans, or None where it has no span recorder."""
    try:
        from seqwin_tpu_torch.engine import timeline
    except ImportError:
        return None
    spans = getattr(timeline, 'spans', None)
    return spans() if callable(spans) else None


def in_jobs(run) -> list | None:
    """The recorded spans inside the traced window's jobs; None where the
    run was not traced or the program records no spans."""
    spans = recorded()
    if spans is None or not run.events or not run.jobs:
        return None
    jobs = [(ev.start_us * 1e3, ev.end_us * 1e3) for ev in run.events
            if not ev.device and ev.name == JOB_SPAN]
    return [s for s in spans if any(a <= s.start_ns and s.end_ns <= b for a, b in jobs)]


def per_job(run, names, scale: float):
    """Summed time of the spans named in ``names`` inside the jobs, per job,
    in units of ``scale`` ns; None where no such span was recorded."""
    spans = in_jobs(run)
    hits = [s.end_ns - s.start_ns for s in spans or () if s.name in names]
    if not hits:
        return None
    return sum(hits) / scale / len(run.jobs)


def attr_per_job(run, name: str, attr: str):
    """Sum of attribute ``attr`` over the spans ``name`` inside the jobs,
    per job; None where no such span carries it."""
    spans = in_jobs(run)
    vals = [s.attrs[attr] for s in spans or () if s.name == name and attr in s.attrs]
    if not vals:
        return None
    return sum(vals) / len(run.jobs)
