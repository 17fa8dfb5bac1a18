"""`ingest_wait_ms`: milliseconds per job in the program's span
`build.ingest_wait` (`graph/build.py`): the build's main thread waiting on
the next assembly its parse threads read."""
from portbench.metrics._spans import per_job


def read(run):
    return per_job(run, ('build.ingest_wait',), 1e6)
