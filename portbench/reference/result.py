"""What one run of the pipeline produced, in a form both sides fill.

`portbench.outputs` fills it from a job's output directory (its
`results.seqwin`, log and files); `portbench.reference.pipeline` fills it
from the FASTAs alone. `portbench.compare` reads two of them.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

FILES = ('signatures.fasta', 'signatures.csv', 'assemblies.csv')


@dataclass
class Outputs:
    kmers: np.ndarray           # kept k-mers: pos, record_idx
    nodes: np.ndarray           # kept nodes: hash, start, stop, n_tar, n_neg, penalty
    edges: np.ndarray           # edges heavier than the threshold: first, second, weight
    record_offsets: np.ndarray  # records before each assembly, and the total
    penalty_th: float           # the threshold the search used (capped)
    threshold_line: str | None  # the threshold as the run's log states it
    subgraphs: list[tuple[int, ...]]  # each subgraph's node ids, sorted, in run order
    markers: list[tuple]        # `marker_key` of each kept candidate, in order
    files: dict[str, bytes | None] = field(default_factory=dict)


def marker_key(path, rep: dict, length: int, n_rep: int, rep_ratio: float,
               warnings, is_bad: bool) -> tuple:
    """Every field of a candidate marker that the outputs derive from."""
    return (None if path is None else tuple(int(x) for x in path),
            rep['assembly_idx'], rep['record_idx'], rep['start'], rep['stop'],
            rep['n_kmers'], tuple(rep['kmers']), rep['is_target'], rep['n_repeats'],
            rep['len'], rep['seq'], length, n_rep, rep_ratio, tuple(sorted(warnings)),
            bool(is_bad))
