"""The plain reference of one CLI job: upstream Seqwin's pipeline from the
FASTAs to its output files.

Only numpy, torch and the standard library: minimizers and the graph's
sorts run as plain torch operations on ``device``, the rest on the host.
It reads the same FASTAs the job read and nothing the job made.

Options: the job's argv as the cell's traffic gives it. The reference knows
``--no-blast`` (required: the card's machine has no BLAST), ``--no-mash``
(the threshold from minimizer counts) or ``--sketch-mode device`` (from
MinHash sketches, `sketches.py`), one of which is required as the machine
has no `mash`, ``--low-memory`` and ``-p/--threads`` (which change no
output), and refuses any other.
Upstream's defaults hold for the rest: stringency 5, min_len 200, no
max_len (at most 100 nodes a subgraph), a threshold cap of 0.2, an
edge-weight multiplier of 0.3, at least 3 nodes a subgraph, seed 42.
"""
from __future__ import annotations

import argparse
import csv
import io
import multiprocessing
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from random import Random

import numpy as np
import torch

from . import fasta, graph, markers, sketches, subgraphs
from .minimizers import SIGN, record_minimizers, seed_tables
from .result import Outputs, marker_key

STRINGENCY = 5
SKETCH_SIZE = 1000
MIN_LEN = 200
MAX_NODES = 100
MIN_NODES_FLOOR = 3
PENALTY_TH_CAP = 0.2
EDGE_W_TH_MUL = 0.3
RUN_SEED = 42
METRIC_COLUMNS = ('conservation', 'f_tar_hits', 'divergence', 'f_neg_hits', 'avg_repeats_tar',
                  'avg_pident_tar', 'avg_repeats_neg', 'avg_pident_neg')


def parse_options(argv: list[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(add_help=False, exit_on_error=False)
    p.add_argument('--no-mash', action='store_true')
    p.add_argument('--no-blast', action='store_true')
    p.add_argument('--low-memory', action='store_true')
    p.add_argument('--threads', '-p', type=int, default=4)
    p.add_argument('--sketch-mode', choices=('auto', 'device'), default='auto')
    args, unknown = p.parse_known_args(argv)
    if unknown:
        raise ValueError(f'the reference does not model the options {unknown}')
    if not args.no_blast or not (args.no_mash or args.sketch_mode == 'device'):
        raise ValueError('the reference models jobs with --no-blast, and --no-mash or '
                         '--sketch-mode device')
    return args


def _stream(records: list[list[np.ndarray]], k: int, w: int, device):
    """Every record's minimizers in scan order, and the adjacent pairs."""
    tables = seed_tables(k, device)
    ids, pos, rec, asm, eu, ev, ea = [], [], [], [], [], [], []
    r = 0
    for a, recs in enumerate(records):
        for codes in recs:
            h, p = record_minimizers(torch.from_numpy(codes).to(device), k, w, tables)
            ids.append(h)
            pos.append(p)
            rec.append(torch.full_like(p, r))
            asm.append(torch.full_like(p, a))
            if h.numel() > 1:
                x, y = h[:-1], h[1:]
                lower = (x ^ SIGN) <= (y ^ SIGN)
                eu.append(torch.where(lower, x, y))
                ev.append(torch.where(lower, y, x))
                ea.append(torch.full_like(x, a))
            r += 1
    empty = [torch.zeros(0, dtype=torch.int64, device=device)]
    return [torch.cat(c or empty) for c in (ids, pos, rec, asm, eu, ev, ea)]


def _subgraph_rows(sg_nodes, groups: dict, record_offsets: np.ndarray):
    parts = [groups[h] for h in sg_nodes]
    ids = np.concatenate([np.full(len(g), h, dtype=np.uint64) for h, g in zip(sg_nodes, parts)])
    pos = np.concatenate([g['pos'] for g in parts]).astype(np.int64)
    rec = np.concatenate([g['record_idx'] for g in parts]).astype(np.int64)
    asm = np.searchsorted(record_offsets, rec, side='right') - 1
    return ids, pos, asm, rec - record_offsets[asm]


def _sub_adjacency(adj: dict, rank: dict, sg) -> dict:
    """The subgraph's adjacency in the parent's node and neighbour order."""
    keep = set(sg)
    return {n: {m: None for m in adj[n] if m in keep} for n in sorted(keep, key=rank.__getitem__)}


def _texts(path: str, spans):
    recs = fasta.record_texts(Path(path))
    return [recs[r][s:e] for r, s, e in spans]


def _csv(header, rows) -> bytes:
    buf = io.StringIO(newline='')
    wr = csv.writer(buf, lineterminator='\n', quoting=csv.QUOTE_MINIMAL)
    wr.writerow(header)
    wr.writerows(rows)
    return buf.getvalue().encode()


def run(paths: list[Path], is_target: list[bool], k: int, w: int, argv: list[str],
        device, penalty_dtype=np.float64, n_cpu: int = 8) -> Outputs:
    """The outputs a job over ``paths`` (targets first) must produce.
    ``penalty_dtype`` below float64 computes penalties and the threshold in
    that precision: the control."""
    opts = parse_options(argv)
    paths = [Path(p).resolve() for p in paths]
    n_tar = sum(is_target)
    n_neg = len(paths) - n_tar
    with ThreadPoolExecutor(max_workers=n_cpu) as ex:
        parsed = list(ex.map(fasta.read_records, paths))
    record_ids = [ids for ids, _ in parsed]
    records = [codes for _, codes in parsed]
    record_offsets = np.cumsum([0] + [len(r) for r in records]).astype(np.uintp)

    node_id, pos, rec, asm, eu, ev, ea = _stream(records, k, w, device)
    kmers, nodes, edges = graph.aggregate(node_id, pos, rec, asm, eu, ev, ea, is_target)
    del node_id, pos, rec, asm, eu, ev, ea
    graph.set_penalties(nodes, n_tar, n_neg, penalty_dtype)
    if opts.sketch_mode == 'device':
        tables = seed_tables(k, device)
        expected = sketches.expectations(
            [sketches.sketch(recs, k, SKETCH_SIZE, tables, device) for recs in records],
            n_tar, SKETCH_SIZE, penalty_dtype)
    else:
        expected = graph.minimizer_expectations(nodes, n_tar, n_neg, penalty_dtype)
    del records
    calculated, penalty_th = graph.penalty_threshold(*expected, STRINGENCY, PENALTY_TH_CAP,
                                                     penalty_dtype)
    weight_th = graph.edge_weight_threshold(penalty_th, n_tar, EDGE_W_TH_MUL)
    kept = graph.kept_edges(edges, weight_th)
    touched = np.unique(np.concatenate([kept['first'], kept['second']]))
    linked = nodes[np.searchsorted(nodes['hash'], touched)]
    adj = subgraphs.adjacency(kept)
    penalty = dict(zip(linked['hash'].tolist(), linked['penalty'].tolist()))
    min_nodes = max(MIN_NODES_FLOOR, MIN_LEN // ((w + 1) // 2) + 1)
    found, used = subgraphs.search(adj, penalty, penalty_th, min_nodes, MAX_NODES,
                                   Random(RUN_SEED))
    kept_kmers, kept_nodes = graph.compact(kmers, nodes, np.array(sorted(used), dtype=np.uint64))
    del kmers

    groups = {int(h): kept_kmers[s:e] for h, s, e in zip(
        kept_nodes['hash'].tolist(), kept_nodes['start'].tolist(), kept_nodes['stop'].tolist())}
    rank = {n: i for i, n in enumerate(adj)}
    jobs = ((_sub_adjacency(adj, rank, sg), _subgraph_rows(tuple(sg), groups, record_offsets),
             k, w, n_tar) for sg in found)
    with multiprocessing.get_context('spawn').Pool(n_cpu) as pool:
        cands = pool.map(markers.candidate_star, jobs, chunksize=max(1, len(found) // (4 * n_cpu)))
        cands = [c for c in cands if c['len'] >= MIN_LEN and not c['is_bad']]
        by_asm: dict[int, list[int]] = {}
        for i, c in enumerate(cands):
            by_asm.setdefault(c['rep']['assembly_idx'], []).append(i)
        spans = [(str(paths[a]), [(cands[i]['rep']['record_idx'], cands[i]['rep']['start'],
                                   cands[i]['rep']['stop']) for i in rows])
                 for a, rows in by_asm.items()]
        seqs = pool.starmap(_texts, spans)
    for rows, got in zip(by_asm.values(), seqs):
        for i, s in zip(rows, got):
            cands[i]['rep']['seq'] = s

    fasta_out, csv_rows, keys = [], [], []
    for c in cands:
        rep = c['rep']
        header = f"{rep['assembly_idx']}-{record_ids[rep['assembly_idx']][rep['record_idx']]}-{rep['start']}:{rep['stop']}"
        fasta_out.append(f">{header}\n{rep['seq']}\n")
        ratio = c['n_rep'] / n_tar
        csv_rows.append((header, c['len'], *[None] * len(METRIC_COLUMNS), ratio, rep['n_kmers']))
        keys.append(marker_key(c['path'], rep, c['len'], c['n_rep'], ratio, c['warnings'], c['is_bad']))
    files = {
        'signatures.fasta': ''.join(fasta_out).encode(),
        'signatures.csv': _csv(('fasta_header', 'length', *METRIC_COLUMNS, 'rep_ratio', 'n_nodes'),
                               csv_rows),
        'assemblies.csv': _csv(('', 'path', 'is_target'),
                               ((i, str(p), t) for i, (p, t) in enumerate(zip(paths, is_target)))),
    }
    return Outputs(kmers=kept_kmers, nodes=kept_nodes, edges=kept, record_offsets=record_offsets,
                   penalty_th=penalty_th, threshold_line=f'{calculated:.5f}',
                   subgraphs=[tuple(sorted(sg)) for sg in found], markers=keys, files=files)
