"""`jaccard_ms`: milliseconds per job in the program's span
`threshold.jaccard` (`pipeline/kmers.py`): the pairwise Jaccard matrix of
the assemblies' sketches."""
from portbench.metrics._spans import per_job


def read(run):
    return per_job(run, ('threshold.jaccard',), 1e6)
