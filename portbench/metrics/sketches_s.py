"""`sketches_s`: seconds per job in the program's span `threshold.sketches`
(`pipeline/kmers.py`): every assembly's MinHash sketch on the device, from
the join of its records to the sketch read back."""
from portbench.metrics._spans import per_job


def read(run):
    return per_job(run, ('threshold.sketches',), 1e9)
