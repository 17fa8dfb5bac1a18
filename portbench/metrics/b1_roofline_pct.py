"""`b1_roofline_pct`: kernel B1's share of its roofline. The least time B1
needs for the bases of a job's records (`peaks.b1_bound_s`), times the jobs,
over the device time of every B1 launch in the trace (found by its kernel
name); nothing where the trace holds no B1 launch."""
from portbench.peaks import B1_KERNEL, b1_bound_s
from portbench.trace import device_time_us


def read(run):
    us, count = device_time_us(run.events or [], B1_KERNEL)
    if not count:
        return None
    return 100 * b1_bound_s(run.positions) * len(run.jobs) / (us / 1e6)
