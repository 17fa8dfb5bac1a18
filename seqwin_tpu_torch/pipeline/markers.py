"""Candidate marker (signature) extraction and evaluation.

Counterpart: `seqwin_tpu/pipeline/markers.py`, without pandas. Candidate
building keeps the reference's semantics (`_get_locs`, `_rep_orders`,
`_get_graph_order`, with the tie-breaks pinned in the docstrings) but runs
over every subgraph at once, in this process: one sort of all their k-mer
rows, NumPy run-length passes in place of the reference's groupby
machinery, and 64-bit fingerprints, checked element by element, in place
of its Counters of tuples; only the linear-path check goes subgraph by
subgraph. BLAST tables are dicts of numpy columns (`ncbi.Table`), and
`signatures.csv` is written with the bytes pandas' `to_csv` gives.

Spans (`engine/timeline.py`): ``phase.markers`` over the phase's timer,
holding ``markers.candidates`` (``rows``, the k-mer rows of the pass, and
``locs``, the largest runs kept; inside it ``markers.candidate_args``, the
rows gathered, with ``nodes``, the subgraphs' nodes, and ``graph_nodes``,
the kept graph's) and ``markers.fetch_seq`` (the representatives cut from
re-read FASTAs, in ``threads`` threads); ``markers.write`` for the two
output files. No process pool runs unless BLAST's metrics are taken.
"""
from __future__ import annotations

import logging
import os
from collections import Counter
from itertools import chain
from dataclasses import asdict, astuple, dataclass, fields
from pathlib import Path
from time import time
from typing import NamedTuple

import numpy as np

from ..assemblies import Assemblies, fetch_threads
from ..config import BLASTCONFIG, CONSEC_KMER_MUL, HAS_BLAST, WORKINGDIR, Config, RunState
from ..engine import timeline
from ..graph.hashgraph import HashGraph, OrderedKmers
from ..ncbi import Table, blast
from ..utils import claim_file, fail, log_elapsed, pool_map, write_csv
from .kmers import KmerGraph

logger = logging.getLogger(__name__)

_BAD_WARNINGS = frozenset((
    'single',  # has only one k-mer
    'dup',     # has duplicate k-mers
    'rev',     # k-mer ordering is reversible
))


@dataclass(slots=True, frozen=True)
class MarkerMetrics:
    """BLAST-derived metrics of a marker (None when BLAST is not run)."""

    conservation: float | None = None
    f_tar_hits: float | None = None
    divergence: float | None = None
    f_neg_hits: float | None = None
    avg_repeats_tar: float | None = None
    avg_pident_tar: float | None = None
    avg_repeats_neg: float | None = None
    avg_pident_neg: float | None = None


_METRIC_NAMES = tuple(f.name for f in fields(MarkerMetrics))
_EMPTY_METRICS = MarkerMetrics()
_BASELINE_METRICS = MarkerMetrics(**{f: 0.0 for f in _METRIC_NAMES})


@dataclass(slots=True)
class MarkerLoc:
    """One occurrence (largest consecutive run) of a subgraph in an assembly."""

    assembly_idx: int
    record_idx: int
    start: int
    stop: int
    n_kmers: int
    kmers: tuple
    is_target: bool
    n_repeats: int = 0
    len: int = 0
    seq: str | None = None


class ConnectedKmers:
    """Candidate marker built from one low-penalty subgraph."""

    __slots__ = (
        'path', 'rep', 'len', 'n_rep', 'blast', 'metrics', 'rep_ratio',
        'warnings', 'is_bad',
    )

    def __init__(
        self, path: OrderedKmers | None, rep: MarkerLoc, n_rep: int, warnings: set[str]
    ) -> None:
        """Args:
            path: the subgraph's linear path in the representative's
                orientation (None when the subgraph is not linear).
            rep: the representative occurrence.
            n_rep: target occurrences with the representative's canonical
                k-mer order.
            warnings: the candidate's warnings (`_BAD_WARNINGS` make it bad).
        """
        self.path = path
        self.rep = rep
        self.len = rep.len
        self.n_rep = n_rep
        self.blast = None
        self.metrics = _EMPTY_METRICS
        self.rep_ratio = None
        self.warnings = warnings
        self.is_bad = not warnings.isdisjoint(_BAD_WARNINGS)


class _Rows(NamedTuple):
    """Every subgraph's k-mer rows, concatenated in subgraph order; the rows
    of subgraph i are ``offsets[i]:offsets[i + 1]``."""

    hashes: np.ndarray   # uint64, the node's hash
    pos: np.ndarray      # int64
    asm: np.ndarray      # intp, the assembly
    rec: np.ndarray      # int64, the record within the assembly
    offsets: np.ndarray  # int64, n_subgraphs + 1


class _Locs(NamedTuple):
    """The largest run of each (subgraph, assembly), in that order, over the
    stream sorted by (subgraph, assembly, record, pos)."""

    hashes: np.ndarray   # the sorted stream's hashes
    sg: np.ndarray
    asm: np.ndarray
    rec: np.ndarray
    first: np.ndarray    # the run's rows in the sorted stream: first:stop
    stop: np.ndarray
    start_pos: np.ndarray
    stop_pos: np.ndarray  # last position + k
    n_repeats: np.ndarray


def _segments(lengths: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(segment id, offset within the segment) of every element of
    segments of ``lengths``."""
    seg = np.repeat(np.arange(len(lengths)), lengths)
    return seg, np.arange(len(seg)) - np.repeat(np.cumsum(lengths) - lengths, lengths)


def _heads(ids: np.ndarray) -> np.ndarray:
    """True at the first element of each run of equal values."""
    head = np.ones(len(ids), dtype=bool)
    head[1:] = ids[1:] != ids[:-1]
    return head


def _gather_rows(kg: KmerGraph) -> _Rows:
    """The rows each subgraph's candidate reads: its nodes in the frozenset's
    iteration order, each node's k-mers in the kept array's order, with the
    record split into (assembly, record within it). Index arithmetic over
    the nodes' start/stop ranges, no loop over rows."""
    subgraphs = kg.subgraphs
    nodes = kg.nodes
    record_offsets = np.asarray(kg.record_offsets, dtype=np.int64)
    sizes = np.fromiter(map(len, subgraphs), dtype=np.int64, count=len(subgraphs))
    node_hashes = np.fromiter(chain.from_iterable(subgraphs), dtype=np.uint64,
                              count=int(sizes.sum()))
    sorter = np.argsort(nodes['hash'])
    at = sorter[np.minimum(np.searchsorted(nodes['hash'], node_hashes, sorter=sorter),
                           len(nodes) - 1)]
    if not np.array_equal(nodes['hash'][at], node_hashes):
        raise KeyError('a subgraph holds a node the kept graph lacks')
    row_start = nodes['start'][at].astype(np.int64)
    counts = nodes['stop'][at].astype(np.int64) - row_start
    node_of, within = _segments(counts)
    kmers = kg.kmers[row_start[node_of] + within]
    rec_g = kmers['record_idx'].astype(np.int64)
    asm = np.searchsorted(record_offsets, rec_g, side='right') - 1
    node_offsets = np.concatenate(([0], np.cumsum(sizes)))
    row_offsets = np.concatenate(([0], np.cumsum(counts)))[node_offsets]
    return _Rows(np.repeat(node_hashes, counts), kmers['pos'].astype(np.int64), asm,
                 rec_g - record_offsets[asm], row_offsets)


def _get_locs(rows: _Rows, kmerlen: int, windowsize: int) -> _Locs:
    """Locate every subgraph in each assembly at once (the reference's
    semantics, subgraph by subgraph).

    1. Sort the rows by (subgraph, assembly, record, pos), stably, so rows
       with equal keys keep the gather's order.
    2. Split into runs where the position gap on the sorted stream exceeds
       1.5 * windowsize, or the subgraph, assembly or record changes.
    3. Keep the largest run of each (subgraph, assembly), the first on
       ties; its runs are its n_repeats; stop is the last position + k.
    """
    sg = np.repeat(np.arange(len(rows.offsets) - 1), np.diff(rows.offsets))
    order = np.lexsort((rows.pos, rows.rec, rows.asm, sg))
    h, pos, asm, rec, sg = (a[order] for a in (rows.hashes, rows.pos, rows.asm, rows.rec, sg))
    n = len(pos)
    cut = np.ones(n, dtype=bool)
    cut[1:] = ((np.diff(pos) > CONSEC_KMER_MUL * windowsize)
               | (asm[1:] != asm[:-1]) | (rec[1:] != rec[:-1]) | (sg[1:] != sg[:-1]))
    run_first = np.flatnonzero(cut)
    run_len = np.diff(np.append(run_first, n))
    run_asm, run_sg = asm[run_first], sg[run_first]
    new_loc = _heads(run_asm) | _heads(run_sg)
    loc_runs = np.flatnonzero(new_loc)
    loc_of = np.cumsum(new_loc) - 1
    longest = np.maximum.reduceat(run_len, loc_runs)
    best = np.flatnonzero(run_len == longest[loc_of])
    best = best[_heads(loc_of[best])]  # the first longest run of each loc
    first = run_first[best]
    stop = first + run_len[best]
    return _Locs(h, run_sg[loc_runs], run_asm[loc_runs], rec[first], first, stop,
                 pos[first], pos[stop - 1] + kmerlen,
                 np.diff(np.append(loc_runs, len(run_first))))


#: the fingerprints' base: odd, so its powers are invertible mod 2^64
_FP_BASE = 0x9E3779B97F4A7C15
_FP_BASE_INV = pow(_FP_BASE, -1, 1 << 64)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64's finalizer, element-wise (uint64 arithmetic wraps)."""
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _fingerprints(
    h: np.ndarray, first: np.ndarray, stop: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """64-bit fingerprints of each slice ``h[first:stop]`` and of its
    reverse: the sum of mix(h[j]) * B^i over the slice's i-th element, from
    two prefix sums mod 2^64. Equal slices give equal fingerprints; the
    converse is for the caller to check."""
    n = len(h)
    pw = np.full(n + 1, _FP_BASE, dtype=np.uint64)
    ipw = np.full(n + 1, _FP_BASE_INV, dtype=np.uint64)
    pw[0] = ipw[0] = 1
    np.cumprod(pw, out=pw)
    np.cumprod(ipw, out=ipw)
    m = _mix64(h)
    fwd = np.zeros(n + 1, dtype=np.uint64)
    bwd = np.zeros(n + 1, dtype=np.uint64)
    np.cumsum(m * pw[:n], out=fwd[1:])
    np.cumsum(m * ipw[:n], out=bwd[1:])
    return (fwd[stop] - fwd[first]) * ipw[first], (bwd[stop] - bwd[first]) * pw[stop - 1]


def _rep_order_exact(orders: list[tuple]) -> tuple[tuple, int]:
    """Most common canonical k-mer ordering among one subgraph's target
    locs (``orders``, in loc order), weighted by length, and its count, by
    the reference's Counters (tie-breaks: Counter insertion order;
    canonical = lexicographically smaller of (order, reversed); orientation
    tie prefers the canonical one)."""
    c: Counter = Counter(orders)
    c_canonical: Counter = Counter()
    for kmers, n in c.items():
        c_canonical[sorted((kmers, kmers[::-1]))[0]] += n
    rep_canonical = max(c_canonical, key=lambda k: len(k) * c_canonical[k])
    rep_order = max((rep_canonical, rep_canonical[::-1]), key=lambda k: c[k])
    return rep_order, c_canonical[rep_canonical]


def _rep_orders(locs: _Locs, n_sg: int, n_tar: int) -> tuple[np.ndarray, np.ndarray]:
    """`_rep_order_exact` for every subgraph at once: each one's
    representative loc (the first loc whose k-mers are the chosen order)
    and n_rep, with no tuple built.

    A target loc's canonical orientation is the reverse where the reverse is
    smaller at the first position where the two differ. Target locs are
    grouped by (subgraph, length, fingerprint of the canonical order), in
    loc order; every member is compared with its group's first member
    element by element, and a subgraph where two orders shared a
    fingerprint is decided by `_rep_order_exact` instead. In each subgraph
    the group with the largest length × count wins, the earliest first
    member on ties (Counter insertion order); its orientation with more
    members wins, the canonical one on ties; the representative is the
    group's first member in that orientation (targets precede non-targets,
    so no earlier loc holds the order)."""
    h = locs.hashes
    tgt = np.flatnonzero(locs.asm < n_tar)
    t_sg, first, stop = locs.sg[tgt], locs.first[tgt], locs.stop[tgt]
    length = stop - first
    seg, j = _segments(length // 2)
    a, b = h[first[seg] + j], h[stop[seg] - 1 - j]
    differ = np.flatnonzero(a != b)
    differ = differ[_heads(seg[differ])]
    rev = np.zeros(len(tgt), dtype=bool)
    rev[seg[differ]] = b[differ] < a[differ]
    fp_fwd, fp_rev = _fingerprints(h, first, stop)
    fp = np.where(rev, fp_rev, fp_fwd)

    order = np.lexsort((fp, length, t_sg))
    head = _heads(t_sg[order]) | _heads(length[order]) | _heads(fp[order])
    grp_first = np.flatnonzero(head)
    grp_of = np.cumsum(head) - 1
    leader = order[grp_first][grp_of]
    seg, j = _segments(length[order])
    mem, ldr = order[seg], leader[seg]
    same = (h[np.where(rev[mem], stop[mem] - 1 - j, first[mem] + j)]
            == h[np.where(rev[ldr], stop[ldr] - 1 - j, first[ldr] + j)])
    collided = np.unique(t_sg[mem[~same]])

    count = np.diff(np.append(grp_first, len(order)))
    n_fwd = np.add.reduceat((~rev[order]).astype(np.int64), grp_first)
    g_sg = t_sg[order[grp_first]]
    weight = length[order[grp_first]] * count
    pick = np.lexsort((order[grp_first], -weight, g_sg))
    pick = pick[_heads(g_sg[pick])]
    if not np.array_equal(g_sg[pick], np.arange(n_sg)):
        missing = np.setdiff1d(np.arange(n_sg), g_sg[pick])[0]
        raise ValueError(f'Subgraph {missing} has no k-mer in a target assembly')
    use_rev = (count - n_fwd) > n_fwd
    hits = np.flatnonzero(rev[order] == use_rev[grp_of])
    rep = tgt[order[hits[_heads(grp_of[hits])]]]
    rep_loc, n_rep = rep[pick], count[pick]

    for i in collided.tolist():
        in_sg = np.flatnonzero(locs.sg == i)
        kmers = [tuple(h[f:e].tolist()) for f, e in zip(locs.first[in_sg], locs.stop[in_sg])]
        rep_order, n_rep[i] = _rep_order_exact(
            [k for k, asm in zip(kmers, locs.asm[in_sg]) if asm < n_tar])
        rep_loc[i] = in_sg[kmers.index(rep_order)]
    return rep_loc, n_rep


def _marker_loc(locs: _Locs, i: int, n_tar: int) -> MarkerLoc:
    first, stop = int(locs.first[i]), int(locs.stop[i])
    start, end = int(locs.start_pos[i]), int(locs.stop_pos[i])
    return MarkerLoc(
        assembly_idx=int(locs.asm[i]),
        record_idx=int(locs.rec[i]),
        start=start,
        stop=end,
        n_kmers=stop - first,
        kmers=tuple(locs.hashes[first:stop].tolist()),
        is_target=bool(locs.asm[i] < n_tar),
        n_repeats=int(locs.n_repeats[i]),
        len=end - start,
    )


def _get_graph_order(graph: HashGraph, rep_order: OrderedKmers, warnings: set) -> OrderedKmers | None:
    """Linear-path check of the subgraph."""
    leaf_nodes = tuple(node for node in graph if graph.degree(node) == 1)
    if len(leaf_nodes) != 2:
        warnings.add('non-linear')
        return None

    all_paths = list(graph.all_simple_paths(*leaf_nodes))
    if len(all_paths) == 1:
        graph_order = all_paths[0]
    else:
        warnings.add('multi-paths')
        graph_order = None
        for path in all_paths:
            path_t = tuple(path)
            if path_t == rep_order:
                graph_order = path_t
                break
            elif path_t == rep_order.rev:
                graph_order = path_t[::-1]
                break
        if graph_order is None:
            graph_order = max(all_paths, key=len)

    if rep_order.which_strand(tuple(graph_order)) == '-':
        graph_order = tuple(graph_order)[::-1]
    graph_order = OrderedKmers(graph_order)
    if graph_order != rep_order:
        warnings.add('inconsistent')
    return graph_order


def _get_candidates(
    kg: KmerGraph, n_tar: int, kmerlen: int, windowsize: int, span=None
) -> list[ConnectedKmers]:
    """Every subgraph's candidate, in subgraph order, from one pass over all
    their k-mer rows; ``rows`` and ``locs`` set on ``span`` when it
    records."""
    subgraphs, graph = kg.subgraphs, kg.graph
    with timeline.span('markers.candidate_args') as a:
        if a:
            a.set(nodes=sum(map(len, subgraphs)), graph_nodes=len(graph))
        rows = _gather_rows(kg)
        order = {n: i for i, n in enumerate(graph)}
    if not subgraphs:
        return []
    locs = _get_locs(rows, kmerlen, windowsize)
    rep_loc, n_rep = _rep_orders(locs, len(subgraphs), n_tar)
    if span:
        span.set(rows=len(rows.pos), locs=len(locs.sg))

    all_cks = []
    for sg, i, n in zip(subgraphs, rep_loc.tolist(), n_rep.tolist()):
        rep = _marker_loc(locs, i, n_tar)
        rep_order = OrderedKmers(rep.kmers)
        warnings: set[str] = set()
        if len(rep_order) == 1:
            warnings.add('single')
        if rep_order.is_dup:
            warnings.add('dup')
        path = _get_graph_order(graph.subgraph(sg, order), rep_order, warnings)
        all_cks.append(ConnectedKmers(path, rep, n, warnings))
    return all_cks


def _fetch_cks_seq(all_cks: list[ConnectedKmers], assemblies: Assemblies, n_cpu: int) -> list[str]:
    """Fetch each candidate's representative sequence."""
    spans = [
        (ck.rep.assembly_idx, ck.rep.record_idx, ck.rep.start, ck.rep.stop)
        for ck in all_cks
    ]
    with timeline.span('markers.fetch_seq') as s:
        if s:
            asms = {a for a, _, _, _ in spans}
            s.set(assemblies=len(asms), threads=fetch_threads(len(asms), n_cpu),
                  bytes=sum(os.path.getsize(assemblies.path[a]) for a in asms))
        all_seq = assemblies.fetch_seq(spans, n_cpu)
        for ck, seq in zip(all_cks, all_seq):
            ck.rep.seq = seq
    return all_seq


def _get_cks(
    kmers: KmerGraph,
    n_tar: int,
    kmerlen: int,
    windowsize: int,
    min_len: int,
    assemblies: Assemblies,
    n_cpu: int,
) -> tuple[list[ConnectedKmers], list[str]]:
    """Create candidates, filter short/bad, fetch representative sequences."""
    logger.info('Finding a representative for each low-penalty subgraph...')
    with timeline.span('phase.markers'):
        tik = time()
        logger.info(' - Processing each subgraph...')
        with timeline.span('markers.candidates', subgraphs=len(kmers.subgraphs)) as s:
            all_cks = _get_candidates(kmers, n_tar, kmerlen, windowsize, s)
            all_cks = [ck for ck in all_cks if (ck.len >= min_len) and (not ck.is_bad)]
            s.set(kept=len(all_cks))
        logger.info(f' - Found {len(all_cks)} candidate signatures')

        logger.info(' - Fetching the representative sequence for each candidate...')
        all_reps = _fetch_cks_seq(all_cks, assemblies, n_cpu=n_cpu)
        for ck in all_cks:
            ck.rep_ratio = ck.n_rep / n_tar
        dt = time() - tik
    log_elapsed(dt)
    return all_cks, all_reps


def _mean(col: np.ndarray) -> np.float64:
    """Mean as pandas' `Series.mean` takes it: a float64 sum (numpy's
    pairwise summation) over a float64 count."""
    return col.sum(dtype=np.float64) / np.float64(len(col))


def _get_avg_ident(nident: np.ndarray, query_len: int, n: int) -> float:
    return sum(nident) / query_len / n


def _get_avg_dist(mismatch: np.ndarray, gaps: np.ndarray, query_len: int, n: int) -> float:
    return sum(mismatch + gaps) / query_len / n


def _get_metrics(blast_out: Table | None, marker_len: int, n_tar: int, n_neg: int) -> MarkerMetrics:
    """Conservation / divergence metrics from best-hit-per-assembly rows."""
    if blast_out is None:
        return _BASELINE_METRICS
    metrics = asdict(_BASELINE_METRICS)
    tar = blast_out['is_target'] == True  # noqa: E712
    if tar.any():
        metrics['conservation'] = _get_avg_ident(blast_out['nident'][tar], marker_len, n_tar)
        metrics['f_tar_hits'] = int(tar.sum()) / n_tar
        metrics['avg_repeats_tar'] = _mean(blast_out['n_hits'][tar])
        metrics['avg_pident_tar'] = _mean(blast_out['avg_nident'][tar]) / marker_len
    neg = blast_out['is_target'] == False  # noqa: E712
    if neg.any():
        metrics['divergence'] = _get_avg_dist(
            blast_out['mismatch'][neg], blast_out['gaps'][neg], marker_len, n_neg)
        metrics['f_neg_hits'] = int(neg.sum()) / n_neg
        metrics['avg_repeats_neg'] = _mean(blast_out['n_hits'][neg])
        metrics['avg_pident_neg'] = _mean(blast_out['avg_nident'][neg]) / marker_len
    return MarkerMetrics(**metrics)


def _best_hits_per_assembly(blast_out: Table) -> Table:
    """Reduce raw BLAST hits to one row per (query, subject assembly).

    Explicit selection rule (re-specification of the reference's
    sort/groupby/head(1) chain, with the tie-break pinned rather than
    inherited from pandas sort internals):

    - the *best hit* of a (qseqid, assembly_idx) group is the row with the
      highest bitscore; ties go to the hit BLAST reported first;
    - each group also gets `n_hits` (its row count) and `avg_nident`
      (mean nident over ALL of its hits, not just the best).

    Output rows are ordered by (qseqid, assembly_idx) ascending; the columns
    are the input's, then n_hits and avg_nident.
    """
    q = blast_out['qseqid']
    a = blast_out['assembly_idx']
    score = blast_out['bitscore']
    rows = np.arange(len(q))
    # grouping order: (query, assembly, -bitscore, original row)
    order = np.lexsort((rows, -score, a, q))
    qs, as_ = q[order], a[order]
    head = np.ones(len(order), dtype=bool)
    head[1:] = (qs[1:] != qs[:-1]) | (as_[1:] != as_[:-1])
    group_starts = np.flatnonzero(head)
    group_sizes = np.diff(np.append(group_starts, len(order)))

    best = {name: col[order[group_starts]] for name, col in blast_out.items()}
    nident_sorted = blast_out['nident'][order].astype(np.float64)
    best['n_hits'] = group_sizes
    best['avg_nident'] = np.add.reduceat(nident_sorted, group_starts) / group_sizes
    return best


def eval_markers(
    all_seqs: list[str], blastdb: Path, n_tar: int, n_neg: int, n_cpu: int = 1
) -> tuple[list[Table | None], list[MarkerMetrics]]:
    """BLAST each marker against the database, keep the best hit per assembly,
    and compute metrics."""
    if blastdb.name == BLASTCONFIG.title_neg_only:
        neg_only = True
        logger.info('BLAST checking signatures against non-target assemblies (less sensitive but faster)...')
    elif blastdb.name == BLASTCONFIG.title_all:
        neg_only = False
        logger.info('BLAST checking signatures against all assemblies (more sensitive but slower)...')
    else:
        fail(ValueError, f'Invalid BLAST database title. Must be "{BLASTCONFIG.title_all}" or "{BLASTCONFIG.title_neg_only}"')
    tik = time()
    n_seqs = len(all_seqs)

    blast_out = blast(
        all_seqs, db=blastdb, task=BLASTCONFIG.task, columns=BLASTCONFIG.columns,
        n_cpu=n_cpu, batch_size=BLASTCONFIG.batch_size,
    )
    if len(blast_out['qseqid']) == 0:
        fail(RuntimeError, 'No BLAST hit found')

    logger.info(' - Formatting BLAST output...')
    # subject ids carry '{assembly_idx}|{t/f}|{record_id}' (see
    # assemblies._rewrite_fasta_headers)
    tags = [str(s).split(BLASTCONFIG.header_sep, 2) for s in blast_out.pop('sseqid')]
    blast_out['assembly_idx'] = np.array([int(t[0]) for t in tags], dtype=np.int64)
    blast_out['is_target'] = np.array([BLASTCONFIG.str2bool[t[1]] for t in tags], dtype=bool)
    blast_out['record_id'] = np.array([t[2] for t in tags], dtype=object)

    best = _best_hits_per_assembly(blast_out)
    all_blast: list = [None] * n_seqs
    q = best['qseqid']
    starts = np.flatnonzero(np.append(True, q[1:] != q[:-1]))
    for s, e in zip(starts, np.append(starts[1:], len(q))):
        all_blast[int(q[s])] = {name: col[s:e].copy() for name, col in best.items()
                                if name != 'qseqid'}

    if not neg_only:
        for i, b in enumerate(all_blast):
            if b is None:
                logger.warning(f'Signature at index {i} (0-based) has no BLAST hit in any assembly ({all_seqs[i][:10]}...)')

    logger.info(' - Evaluating each signature...')
    metrics_args = (
        (b, len(seq), n_tar, n_neg) for b, seq in zip(all_blast, all_seqs)
    )
    metrics = pool_map(_get_metrics, metrics_args, n_cpu, total=n_seqs)
    log_elapsed(time() - tik)
    return all_blast, metrics


def _eval_cks(all_cks, all_reps, blastdb, n_tar, n_neg, n_cpu) -> None:
    results = eval_markers(all_reps, blastdb, n_tar, n_neg, n_cpu)
    for ck, bl, metrics in zip(all_cks, *results):
        ck.blast, ck.metrics = bl, metrics
    all_cks.sort(key=lambda ck: ck.metrics.conservation + ck.metrics.divergence, reverse=True)


def get_markers(
    kmers: KmerGraph, assemblies: Assemblies, config: Config, state: RunState
) -> list[ConnectedKmers]:
    """Extract candidate signatures and write signatures.fasta / .csv
    (the reference's output contract, byte-identical)."""
    n_tar = state.n_tar
    n_neg = state.n_neg
    working_dir = state.working_dir

    all_cks, all_reps = _get_cks(
        kmers, n_tar, config.kmerlen, config.windowsize, config.min_len,
        assemblies, config.n_cpu,
    )

    if config.run_blast and HAS_BLAST:
        logger.info('Evaluating candidate signatures with BLAST...')
        blastdb = assemblies.makeblastdb(
            prefix=working_dir / WORKINGDIR.blast_dir,
            neg_only=config.blast_neg_only,
            overwrite=config.overwrite,
            n_cpu=config.n_cpu,
        )
        _eval_cks(all_cks, all_reps, blastdb, n_tar, n_neg, config.n_cpu)
    else:
        if config.run_blast:
            logger.error('BLAST+ is not installed. Signature evaluation is skipped.')
        else:
            logger.warning('Signature evaluation is turned off (--no-blast), skip running BLAST')
        blastdb = None

    with timeline.span('markers.write', markers=len(all_cks)):
        markers_fasta = working_dir / WORKINGDIR.markers_fasta
        claim_file(markers_fasta, config.overwrite)
        fasta = []
        csv = []
        all_record_ids = assemblies.record_ids
        for ck in all_cks:
            rep = ck.rep
            record_id = all_record_ids[rep.assembly_idx][rep.record_idx]
            header = f'{rep.assembly_idx}-{record_id}-{rep.start}:{rep.stop}'
            fasta.append(f'>{header}\n{rep.seq}\n')
            csv.append((header, ck.len, *astuple(ck.metrics), ck.rep_ratio, rep.n_kmers))
        markers_fasta.write_text(''.join(fasta), encoding='utf-8', newline='\n')
        logger.info(f'Candidate signatures saved as {markers_fasta}')

        markers_csv = working_dir / WORKINGDIR.markers_csv
        claim_file(markers_csv, config.overwrite)
        write_csv(markers_csv, ('fasta_header', 'length', *_METRIC_NAMES, 'rep_ratio', 'n_nodes'),
                  csv)
        logger.info(f'Metrics of candidate signatures saved as {markers_csv}')

    state.blastdb = blastdb
    return all_cks
