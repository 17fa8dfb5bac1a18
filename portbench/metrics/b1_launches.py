"""`b1_launches`: launches of kernel B1 (`phase1_z`) per job, from the
program's counter `engine.phase1.phase1_z.launches`; nothing where B1 did
not run."""


def read(run):
    if not run.jobs:
        return None
    n = sum(job.counters.get('b1_launches', 0) for job in run.jobs) / len(run.jobs)
    return n or None
