"""`sketch_roofline_pct`: the device sketches' share of their roofline. The
least time the estimator needs for the bases of a job's records
(`sketch_peaks.sketch_bound_s`), times the program's `threshold.sketches`
spans inside the jobs, over the union of the device intervals (kernels,
copies, sets) that fall inside those spans, each cut to its span: work on
several streams at once counts once. Nothing where the program records no
such span or the trace holds no device work inside one."""
from portbench.metrics._spans import in_jobs
from portbench.sketch_peaks import sketch_bound_s
from portbench.trace import merged


def read(run):
    spans = [(s.start_ns / 1e3, s.end_ns / 1e3) for s in in_jobs(run) or ()
             if s.name == 'threshold.sketches']
    device = [(ev.start_us, ev.end_us) for ev in run.events or () if ev.device]
    busy_us = sum(e - s for a, b in spans
                  for s, e in merged((max(s, a), min(e, b)) for s, e in device if s < b and e > a))
    if not busy_us:
        return None
    return 100 * sketch_bound_s(run.positions) * len(spans) / (busy_us / 1e6)
