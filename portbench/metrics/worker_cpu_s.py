"""`worker_cpu_s`: CPU seconds per job of the program's forked pool
workers: the counter `child_cpu_s` (user plus system seconds of the reaped
children) of every `pool.stop` span (`utils.pool_map`)."""
from portbench.metrics._spans import attr_per_job


def read(run):
    return attr_per_job(run, 'pool.stop', 'child_cpu_s')
