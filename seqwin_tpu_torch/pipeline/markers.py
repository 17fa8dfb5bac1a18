"""Candidate marker (signature) extraction and evaluation.

Counterpart: `seqwin_tpu/pipeline/markers.py`, without pandas. Candidate
building (`ConnectedKmers`, `_get_loc`, `_get_rep_order`,
`_get_graph_order`) is a copy: NumPy run-length passes in place of the
reference's groupby machinery, with the tie-breaks pinned in the
docstrings. BLAST tables are dicts of numpy columns (`ncbi.Table`), and
`signatures.csv` is written with the bytes pandas' `to_csv` gives.

Spans (`engine/timeline.py`): ``phase.markers`` over the phase's timer,
holding ``markers.candidates`` (the subgraphs' arguments built,
``markers.candidate_args`` with ``nodes``, the subgraphs' nodes, and
``graph_nodes``, the kept graph's, and the candidates made in forked
workers) and ``markers.fetch_seq`` (the representatives cut from re-read
FASTAs); ``markers.write`` for the two output files.
"""
from __future__ import annotations

import logging
import os
from collections import Counter
from dataclasses import asdict, astuple, dataclass, fields
from pathlib import Path
from time import time

import numpy as np

from ..assemblies import Assemblies
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
        self,
        graph: HashGraph,
        kmer_rows: tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
        kmerlen: int,
        windowsize: int,
        n_tar: int,
    ) -> None:
        """Args:
            graph: the subgraph (adjacency over node hashes).
            kmer_rows: (hash u64, pos, assembly_idx, record_idx_local) arrays
                for every k-mer of the subgraph.
            kmerlen, windowsize: minimizer parameters.
            n_tar: number of target assemblies.
        """
        warnings: set[str] = set()
        loc = _get_loc(kmer_rows, kmerlen, windowsize, n_tar)
        rep_order, n_rep = _get_rep_order(loc, warnings)
        rep = next(row for row in loc if row.kmers == rep_order)
        graph_order = _get_graph_order(graph, rep_order, warnings)
        is_bad = len(warnings.intersection(_BAD_WARNINGS)) > 0

        self.path = graph_order
        self.rep = rep
        self.len = rep.len
        self.n_rep = n_rep
        self.blast = None
        self.metrics = _EMPTY_METRICS
        self.rep_ratio = None
        self.warnings = warnings
        self.is_bad = is_bad


def _get_loc(kmer_rows, kmerlen: int, windowsize: int, n_tar: int) -> list[MarkerLoc]:
    """Locate the subgraph in each assembly (the reference's semantics).

    1. Sort k-mers by (assembly, record, pos) -- keys are unique, so the order
       is fully determined.
    2. Split into runs where the position gap exceeds 1.5 * windowsize
       (gap computed on the sorted stream, crossing record boundaries exactly
       like the reference's ``diff``; groups additionally split on
       assembly/record change).
    3. Keep the largest run per assembly (first on ties), count runs as
       n_repeats, extend stop by k.
    """
    hashes, pos, asm, rec = kmer_rows
    order = np.lexsort((pos, rec, asm))
    hashes = hashes[order]
    pos = pos[order].astype(np.int64)
    asm = asm[order]
    rec = rec[order]

    n = len(pos)
    # pandas semantics: groups split when diff(pos) > 1.5*w on the *sorted
    # stream*, then grouped by (assembly, record, group id).
    gap = np.zeros(n, dtype=bool)
    if n > 1:
        gap[1:] = np.diff(pos) > CONSEC_KMER_MUL * windowsize
    boundary = gap.copy()
    boundary[0] = True
    if n > 1:
        boundary[1:] |= (asm[1:] != asm[:-1]) | (rec[1:] != rec[:-1])
    starts = np.flatnonzero(boundary)
    stops = np.append(starts[1:], n)

    # per-assembly selection: groups are contiguous in assembly order
    locs: list[MarkerLoc] = []
    g = 0
    n_groups = len(starts)
    while g < n_groups:
        a = asm[starts[g]]
        best = g
        count = 0
        while g < n_groups and asm[starts[g]] == a:
            if (stops[g] - starts[g]) > (stops[best] - starts[best]):
                best = g
            count += 1
            g += 1
        s, e = int(starts[best]), int(stops[best])
        start = int(pos[s])
        stop = int(pos[e - 1]) + kmerlen
        locs.append(MarkerLoc(
            assembly_idx=int(a),
            record_idx=int(rec[s]),
            start=start,
            stop=stop,
            n_kmers=e - s,
            kmers=tuple(int(h) for h in hashes[s:e]),
            is_target=bool(a < n_tar),
            n_repeats=count,
            len=stop - start,
        ))
    return locs


def _get_rep_order(loc: list[MarkerLoc], warnings: set) -> tuple[OrderedKmers, int]:
    """Most common canonical k-mer ordering among targets, weighted by length
    (tie-breaks: Counter insertion order; canonical =
    lexicographically smaller of (order, reversed); orientation tie prefers
    the canonical one)."""
    c: Counter = Counter(row.kmers for row in loc if row.is_target)
    c_canonical: Counter = Counter()
    for kmers, n in c.items():
        c_canonical[sorted((kmers, kmers[::-1]))[0]] += n
    rep_canonical = max(c_canonical, key=lambda k: len(k) * c_canonical[k])
    rep_order = OrderedKmers(max(
        (rep_canonical, rep_canonical[::-1]),
        key=lambda k: c[k],
    ))
    if len(rep_order) == 1:
        warnings.add('single')
    if rep_order.is_dup:
        warnings.add('dup')
    return rep_order, c_canonical[rep_canonical]


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


def _create_ck(graph, kmer_rows, kmerlen, windowsize, n_tar):
    return ConnectedKmers(graph, kmer_rows, kmerlen, windowsize, n_tar)


def _get_create_ck_args(kg: KmerGraph, n_tar: int, kmerlen: int, windowsize: int):
    """Yield per-subgraph args (node order is the frozenset iteration order;
    k-mer groups concatenated in that order). Each subgraph's graph is cut
    from its own nodes by the kept graph's node ranks, so the whole costs
    the subgraphs' size, not their number times the graph's."""
    kmers = kg.kmers
    nodes = kg.nodes
    graph = kg.graph
    record_offsets = np.asarray(kg.record_offsets, dtype=np.int64)

    kmer_groups = {}
    for node in nodes:
        h, start, stop = int(node['hash']), int(node['start']), int(node['stop'])
        kmer_groups[h] = kmers[start:stop]

    order = {n: i for i, n in enumerate(graph)}
    for sg in kg.subgraphs:
        arg_graph = graph.subgraph(sg, order)
        arg_nodes = tuple(sg)
        groups = [kmer_groups.pop(int(h)) for h in arg_nodes]
        n_rows = sum(len(g) for g in groups)
        hashes = np.zeros(n_rows, dtype=np.uint64)
        pos = np.zeros(n_rows, dtype=np.int64)
        rec_g = np.zeros(n_rows, dtype=np.int64)
        off = 0
        for h, grp in zip(arg_nodes, groups):
            hashes[off:off + len(grp)] = np.uint64(h)
            pos[off:off + len(grp)] = grp['pos']
            rec_g[off:off + len(grp)] = grp['record_idx']
            off += len(grp)
        asm = np.searchsorted(record_offsets, rec_g, side='right') - 1
        rec_local = rec_g - record_offsets[asm]
        yield arg_graph, (hashes, pos, asm, rec_local), kmerlen, windowsize, n_tar


def _fetch_cks_seq(all_cks: list[ConnectedKmers], assemblies: Assemblies, n_cpu: int) -> list[str]:
    """Fetch each candidate's representative sequence."""
    spans = [
        (ck.rep.assembly_idx, ck.rep.record_idx, ck.rep.start, ck.rep.stop)
        for ck in all_cks
    ]
    with timeline.span('markers.fetch_seq') as s:
        if s:
            asms = {a for a, _, _, _ in spans}
            s.set(assemblies=len(asms),
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
            # a list, as `Pool.starmap` makes of an iterable without a length
            with timeline.span('markers.candidate_args') as a:
                if a:
                    a.set(nodes=sum(map(len, kmers.subgraphs)), graph_nodes=len(kmers.graph))
                args = list(_get_create_ck_args(kmers, n_tar, kmerlen, windowsize))
            all_cks: list[ConnectedKmers] = pool_map(
                _create_ck, args, processes=n_cpu, total=len(args))
            del args
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
