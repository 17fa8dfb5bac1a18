"""`candidate_args_ms`: milliseconds per job in the program's span
`markers.candidate_args` (`pipeline/markers.py`): each subgraph's induced
graph and k-mer rows built in the parent before the workers fork."""
from portbench.metrics._spans import per_job


def read(run):
    return per_job(run, ('markers.candidate_args',), 1e6)
