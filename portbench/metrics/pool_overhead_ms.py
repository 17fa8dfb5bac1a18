"""`pool_overhead_ms`: milliseconds per job in the program's spans
`pool.start` (a process pool forked) and `pool.stop` (its workers ended and
reaped), over every pool of the job (`utils.pool_map`)."""
from portbench.metrics._spans import per_job


def read(run):
    return per_job(run, ('pool.start', 'pool.stop'), 1e6)
