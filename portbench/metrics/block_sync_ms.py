"""`block_sync_ms`: milliseconds per job in the program's span `block.sync`
(`engine/hybrid.py`): the block path's host reads (the emission's boolean
index and the halo's drop count), two a block, each waiting on the card.
Nothing where no record is scanned in blocks."""
from portbench.metrics._spans import per_job


def read(run):
    return per_job(run, ('block.sync',), 1e6)
