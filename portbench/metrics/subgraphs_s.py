"""`subgraphs_s`: seconds per job of the program's subgraphs phase (its own
`Finished in` timer, keyed by the phase's log heading), summed over the
traced jobs and divided by their number."""
from portbench.metrics._common import mean_phase


def read(run):
    return mean_phase(run, 'subgraphs')
