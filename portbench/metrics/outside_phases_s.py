"""`outside_phases_s`: seconds per job outside the four timed phases: the
CLI and `core.run` (config, `assemblies.get_assemblies`, the output
directory, the `results.seqwin` pickle). A job's wall time less its phase
seconds, averaged over the traced jobs."""
from portbench.phases import PHASES


def read(run):
    if not run.jobs or any(any(p not in job.phases for p in PHASES) for job in run.jobs):
        return None
    rest = [job.wall_s - sum(job.phases[p] for p in PHASES) for job in run.jobs]
    return sum(rest) / len(rest)
