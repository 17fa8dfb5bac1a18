"""`prep_wait_ms`: milliseconds per job in the program's span
`build.prep_wait` (`graph/build.py`): the build's main thread blocked on a
chunk's host prep. Nothing where no chunk is deferred (every record in
blocks, as under `--low-memory` with complete genomes)."""
from portbench.metrics._spans import per_job


def read(run):
    return per_job(run, ('build.prep_wait',), 1e6)
