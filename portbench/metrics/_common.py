"""Helpers the metric readers share."""
from __future__ import annotations


def mean_phase(run, phase: str):
    """Mean seconds of ``phase`` per job, or None where a job did not time it."""
    vals = [job.phases.get(phase) for job in run.jobs]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals) / len(vals)
