"""`aggregate_ms`: host milliseconds per job inside the program's span
`build.aggregate` (`graph/build.py`, the graph's sorts and merges and the
nodes' copy to the host), from the traced window's profiler events."""
from portbench.trace import span_time_us


def read(run):
    us, count = span_time_us(run.events or [], 'build.aggregate')
    return us / 1e3 / len(run.jobs) if count and run.jobs else None
