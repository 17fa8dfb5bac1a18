"""`peak_device_gib`: the most device memory the window's jobs held
allocated at once (`torch.cuda.max_memory_allocated()` after
`reset_peak_memory_stats()` at the window's start), in GiB."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
