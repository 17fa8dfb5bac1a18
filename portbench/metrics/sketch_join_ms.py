"""`sketch_join_ms`: milliseconds per job in the program's spans
`sketch.join` (`mash.py`), one an assembly: the host join of its records
into one separator stream and the copy of it to the device."""
from portbench.metrics._spans import per_job


def read(run):
    return per_job(run, ('sketch.join',), 1e6)
