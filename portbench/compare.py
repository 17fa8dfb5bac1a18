"""The comparison that decides ``correct``: a job's outputs against the
reference's, over every layer a job passes through.

Two numbers, each limited to 0, as the pipeline's outputs are exact
(PERF.md gives the readings the limits were set from):
- ``rows_differing``: the rows that differ, summed over the layers
  (`layers`): the kept k-mers, nodes (penalties bit for bit), edges and
  record offsets; the subgraphs (node sets, in run order); the candidate
  markers (every field); the lines of signatures.fasta, signatures.csv and
  assemblies.csv. Where lengths differ every row counts, and every line of
  a file one side lacks;
- ``threshold_gap``: the larger gap of the threshold the search used and of
  the one the log states (1 where either is missing).
"""
from __future__ import annotations

import math

import numpy as np

from .reference.result import FILES, Outputs

LIMITS = {'rows_differing': 0, 'threshold_gap': 0}


def _rows(a: np.ndarray, b: np.ndarray) -> int:
    if len(a) != len(b) or a.dtype.names != b.dtype.names:
        return max(len(a), len(b), 1)
    if a.dtype.names is None:
        return int(np.count_nonzero(a != b))
    differ = np.zeros(len(a), dtype=bool)
    for name in a.dtype.names:
        differ |= a[name] != b[name]
    return int(np.count_nonzero(differ))


def _items(a: list, b: list) -> int:
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))


def _lines(a: bytes | None, b: bytes | None) -> int:
    if a is None or b is None:
        return max(len((a or b or b'x').splitlines()), 1)
    la, lb = a.splitlines(), b.splitlines()
    return _items(la, lb)


def _gap(a, b) -> float:
    try:
        a, b = float(a), float(b)
    except (TypeError, ValueError):
        return 1.0
    return 1.0 if math.isnan(a) or math.isnan(b) else abs(a - b)


def layers(want: Outputs, got: Outputs) -> dict[str, int]:
    """Rows that differ in each layer's outputs."""
    return {
        'graph': sum(_rows(getattr(want, f), getattr(got, f))
                     for f in ('kmers', 'nodes', 'edges', 'record_offsets')),
        'subgraphs': _items(want.subgraphs, got.subgraphs),
        'markers': _items(want.markers, got.markers),
        'files': sum(_lines(want.files.get(n), got.files.get(n)) for n in FILES),
    }


def compare(want: Outputs, got: Outputs) -> dict[str, float]:
    return {
        'rows_differing': sum(layers(want, got).values()),
        'threshold_gap': max(_gap(want.penalty_th, got.penalty_th),
                             _gap(want.threshold_line, got.threshold_line)),
    }


def worst(readings: list[dict[str, float]]) -> dict[str, float]:
    """Each number's largest reading over jobs."""
    return {name: max(r[name] for r in readings) for name in LIMITS} if readings else {}


def passes(numbers: dict[str, float]) -> bool:
    return bool(numbers) and all(numbers[n] <= lim for n, lim in LIMITS.items())
