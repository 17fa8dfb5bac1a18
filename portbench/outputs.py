"""A job's outputs as `reference.result.Outputs`: its `results.seqwin` (the
kept graph, the threshold, the subgraphs and the candidate markers), the
threshold line of its log, and its three output files.

Unpickling `results.seqwin` needs the program's classes, so this runs in
the harness's process, after the window.
"""
from __future__ import annotations

import pickle
import re
from pathlib import Path

import numpy as np

from .reference.graph import EDGE_DTYPE, KMER_DTYPE, NODE_DTYPE
from .reference.result import FILES, Outputs, marker_key

_THRESHOLD = re.compile(r' - calculated penalty threshold: ([0-9.]+)')


def empty() -> Outputs:
    return Outputs(kmers=np.zeros(0, KMER_DTYPE), nodes=np.zeros(0, NODE_DTYPE),
                   edges=np.zeros(0, EDGE_DTYPE), record_offsets=np.zeros(0, np.uintp),
                   penalty_th=float('nan'), threshold_line=None, subgraphs=[], markers=[],
                   files={name: None for name in FILES})


def _rep(loc) -> dict:
    return dict(assembly_idx=loc.assembly_idx, record_idx=loc.record_idx, start=loc.start,
                stop=loc.stop, n_kmers=loc.n_kmers, kmers=loc.kmers, is_target=loc.is_target,
                n_repeats=loc.n_repeats, len=loc.len, seq=loc.seq)


def read(job_dir: Path) -> Outputs:
    """What the job in ``job_dir`` produced; whatever is missing reads as
    empty."""
    out = empty()
    out.files = {name: (job_dir / name).read_bytes() if (job_dir / name).is_file() else None
                 for name in FILES}
    log = job_dir / 'seqwin.log'
    found = _THRESHOLD.findall(log.read_text()) if log.is_file() else []
    out.threshold_line = found[-1] if found else None
    results = job_dir / 'results.seqwin'
    if not results.is_file():
        return out
    run = pickle.loads(results.read_bytes())
    kg = run.kmers
    out.kmers, out.nodes, out.edges = kg.kmers, kg.nodes, kg.edges
    out.record_offsets = np.asarray(kg.record_offsets)
    out.penalty_th = float(run.state.penalty_th)
    out.subgraphs = [tuple(sorted(int(h) for h in sg)) for sg in kg.subgraphs]
    out.markers = [marker_key(ck.path, _rep(ck.rep), ck.len, ck.n_rep, ck.rep_ratio,
                              ck.warnings, ck.is_bad) for ck in run.markers]
    return out
