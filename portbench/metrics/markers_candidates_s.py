"""`markers_candidates_s`: seconds per job in the program's span
`markers.candidates` (`pipeline/markers.py`): the subgraphs' arguments
built in the parent and the candidates made in forked workers, the pool's
fork and exit included."""
from portbench.metrics._spans import per_job


def read(run):
    return per_job(run, ('markers.candidates',), 1e9)
