"""`device_idle_pct`: the share of the traced window in which no kernel,
copy or set ran on the device: 100 * (1 - the union of device intervals /
the window's wall time)."""
from portbench.trace import device_busy_us


def read(run):
    if not run.events or run.window_s <= 0:
        return None
    return 100 * (1 - device_busy_us(run.events) / 1e6 / run.window_s)
