"""`setup_s`: seconds from the harness's start to the window's: imports and
the CUDA context, the cell's FASTAs, the port's kernel and ingest builds
(the first run in a checkout only) and one whole warm-up job."""


def read(run):
    return run.setup_s
