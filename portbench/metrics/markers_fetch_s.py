"""`markers_fetch_s`: seconds per job in the program's span
`markers.fetch_seq` (`pipeline/markers.py`): the candidates'
representatives cut from the FASTAs, re-read in a pool of forked
workers."""
from portbench.metrics._spans import per_job


def read(run):
    return per_job(run, ('markers.fetch_seq',), 1e9)
