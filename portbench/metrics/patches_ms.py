"""`patches_ms`: milliseconds per job in the program's span `hybrid.patches`
(`engine/hybrid.py`), summed over threads: every chunk's irregular-window
patches (`host_patches`: the windows at record heads, record junctions and
N runs, resolved on the host), inside `hybrid.host_prep`, mostly in the prep
pool's threads. Nothing where the program records no such span."""
from portbench.metrics._spans import per_job


def read(run):
    return per_job(run, ('hybrid.patches',), 1e6)
