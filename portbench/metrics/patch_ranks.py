"""`patch_ranks`: positions hashed per job by the irregular-window patches,
the sum of attribute ``ranks`` of the program's spans `hybrid.patches`
(`engine/hybrid.py`). It counts the patches' work, which a change of
algorithm can lower and a change of speed cannot. Nothing where the
program records no such span."""
from portbench.metrics._spans import attr_per_job


def read(run):
    return attr_per_job(run, 'hybrid.patches', 'ranks')
