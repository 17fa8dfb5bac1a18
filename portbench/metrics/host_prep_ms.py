"""`host_prep_ms`: milliseconds per job in the program's span
`hybrid.host_prep` (`engine/hybrid.py`), in every thread: the chunks' host
layout and irregular-window patches, mostly in the prep pool's threads,
which the profiler does not see."""
from portbench.metrics._spans import per_job


def read(run):
    return per_job(run, ('hybrid.host_prep',), 1e6)
