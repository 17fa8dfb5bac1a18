"""`job_s`: the window's wall time over the jobs it completed (host clock;
the window ends after the last job and a device synchronize): the wait of a
user for one CLI run."""


def read(run):
    return run.window_s / len(run.jobs) if run.jobs else None
