"""End-to-end minimizer graph construction.

Counterpart: `seqwin_tpu/graph/build.py` (`build`, `build_deferred`,
`_build_impl`, `_build_numpy`, `kept_node_layout`, `filter_kmers`).

    host FASTA ingest -> base-code streams
      -> chunked scan on the device (`engine/hybrid.scan_chunk_deferred`)
      -> stable sorts + run merges on the device (`engine/aggregate.py`)
      -> numpy arrays in the output contract.

Records are packed into chunks of at most ``DEFAULT_CHUNK_BASES`` bases
(2^25; ``LOW_MEMORY_CHUNK_BASES``, 2^22, with ``low_memory``),
in global scan order, so the output is the same for any chunking. Chunk
host prep runs in a pool of min(4, n_cpu) threads; the main thread
dispatches each chunk in chunk order without a host sync, fetches every
chunk's emitted count at once after the last, and re-runs a chunk whose
emission passed its capacity (`counters`). A record longer than the budget
is scanned alone in halo'd blocks (`engine/hybrid.scan_record_blocks`,
which syncs per block). ``SEQWIN_TPU_TORCH_SCAN=sort`` scans
the chunks with the plain torch sort engine (`engine/minimizer.py`) instead,
which does not split records. ``devices != 1`` takes the multi-device build
(`parallel/distributed.py`) over that many cards of this host, with the
same output. ``backend='numpy'|'oracle'`` builds on the host with
`ops/host_build.py` or `ops/oracle.py` and touches no device.
``SEQWIN_TPU_MULTIHOST`` set takes the multi-host build
(`parallel/multihost.py`) over every process of a `torch.distributed` group.

Spans (`engine/timeline.py`): ``build`` around a build; in it
``build.ingest_wait`` (the main thread waiting on the next parsed assembly;
the parse threads' ``io.parse`` are children of ``build``),
``hybrid.host_prep`` in the prep pool's threads (its irregular-window
patches ``hybrid.patches`` inside), ``build.prep_wait`` (the
main thread blocked on a prep future), ``build.dispatch`` (a deferred
chunk's enqueue), ``build.blocks`` per long record (its ``block.sync``
reads inside), ``build.counts_fetch`` and ``build.aggregate``.
"""
from __future__ import annotations

import logging
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterable

import numpy as np
import torch

from ..device import resolve_device
from ..engine import timeline
from ..engine.aggregate import HostGraph, aggregate_device
from ..engine.hybrid import (pinned_host_prep, scan_chunk_deferred, scan_chunk_device,
                             scan_record_blocks)
from ..engine.minimizer import scan_chunk_sort
from ..io.fasta import U32_MAX, iter_assemblies, parse_fasta_codes
from ..parallel import multihost
from ..parallel.distributed import build_distributed
from .dtypes import KMER_DTYPE

logger = logging.getLogger(__name__)

# Max bases per device scan call; read when a build starts, so tests may patch them.
DEFAULT_CHUNK_BASES = 1 << 25
LOW_MEMORY_CHUNK_BASES = 1 << 22

# The build's one documented second try, counted since the process started
# (or since a caller set it to 0): a deferred chunk whose emission passed its
# capacity, scanned again exactly.
counters = {'overflow_reruns': 0}


def build(
    assembly_paths: Iterable[Path | str],
    kmerlen: int,
    windowsize: int,
    is_targets: Iterable[bool],
    n_cpu: int = 1,
    low_memory: bool = False,
    backend: str = 'auto',
    devices: int = 1,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, list[tuple[str, ...]]]:
    """Build a minimizer graph from assembly FASTA files on ``device``
    (default: the GPU; raises when there is none). ``devices`` shards the
    build over that many cards (0: all of them; capped at the cards
    present); with ``device='cpu'`` the shards all run on the CPU.
    ``low_memory`` cuts the chunk budget to ``LOW_MEMORY_CHUNK_BASES`` (and
    the multi-device build into batches of whole assemblies);
    ``backend='numpy'|'oracle'`` builds on the host and needs no device.

    Returns:
        (kmers, nodes, edges, record_offsets, record_ids)
        - kmers: KMER_DTYPE[M], minimizer occurrences grouped by node, scan
          order within each group;
        - nodes: NODE_DTYPE[U] sorted by hash (penalty zeroed);
        - edges: EDGE_DTYPE[E] sorted by (first, second);
        - record_offsets: uintp[A+1] cumulative record counts per assembly;
        - record_ids: per assembly, tuple of FASTA record ids.
    """
    return _build_impl(assembly_paths, kmerlen, windowsize, is_targets,
                       n_cpu=n_cpu, low_memory=low_memory, backend=backend,
                       defer=False, devices=devices, device=device)


def build_deferred(
    assembly_paths: Iterable[Path | str],
    kmerlen: int,
    windowsize: int,
    is_targets: Iterable[bool],
    n_cpu: int = 1,
    low_memory: bool = False,
    backend: str = 'auto',
    keep_codes: bool = False,
    devices: int = 1,
    device=None,
):
    """`build` variant returning (graph, record_offsets, record_ids) where
    ``graph`` keeps the k-mer stream and edges on the device
    (`engine.aggregate.DeviceGraph`; ``graph.nodes`` is on the host). The
    multi-device and host builds hand back host arrays in an
    `engine.aggregate.HostGraph` of the same interface.

    ``keep_codes`` keeps the parsed base codes on ``graph.record_codes``
    (per assembly, the list of its record code arrays; host RAM of the
    dataset's size), so the device MinHash sketches need no second parse.
    The multi-host build keeps none."""
    return _build_impl(assembly_paths, kmerlen, windowsize, is_targets,
                       n_cpu=n_cpu, low_memory=low_memory, backend=backend,
                       defer=True, devices=devices, device=device, keep_codes=keep_codes)


def _shard_devices(devices: int, dev: torch.device) -> list[torch.device]:
    """The shards of a ``devices`` request, as the JAX package maps it onto
    its mesh: 0 means every card, a request above the cards present takes
    them all with a warning. On the CPU (``device='cpu'``) nothing caps the
    count: ``devices`` shards on the CPU, one for 0."""
    if dev.type == 'cpu':
        return [dev] * max(1, int(devices))
    n_avail = torch.cuda.device_count()
    n_dev = n_avail if devices == 0 else min(int(devices), n_avail)
    if devices > n_avail:
        logger.warning(f'Requested {devices} devices but only {n_avail} are '
                       f'available; using {n_dev}')
    return [torch.device('cuda', i) for i in range(n_dev)]


def _build_impl(assembly_paths, kmerlen: int, windowsize: int, is_targets,
                n_cpu: int, low_memory: bool, backend: str, defer: bool,
                devices: int = 1, device=None, keep_codes: bool = False):
    timeline.gate()
    with timeline.span('build'):
        return _build_body(assembly_paths, kmerlen, windowsize, is_targets, n_cpu, low_memory,
                           backend, defer, devices, device, keep_codes)


def _build_body(assembly_paths, kmerlen, windowsize, is_targets, n_cpu, low_memory, backend,
                defer, devices, device, keep_codes):
    paths = [str(p) for p in assembly_paths]
    targets = [bool(t) for t in is_targets]
    if len(paths) != len(targets):
        raise ValueError('assembly_paths and is_targets must have the same length')
    if len(paths) > U32_MAX:
        raise ValueError('Number of input assemblies exceeds uint32 range')
    if backend in ('numpy', 'oracle'):
        kmers, nodes, edges, offsets, record_ids, seqs = _build_numpy(
            paths, kmerlen, windowsize, targets, oracle=backend == 'oracle')
        if not defer:
            return kmers, nodes, edges, offsets, record_ids
        graph = HostGraph(kmers, nodes, edges)
        if keep_codes:
            graph.record_codes = seqs
        return graph, offsets, record_ids
    dev = resolve_device(device)
    # '' or '1': an initialized process group (or one process);
    # 'coord:port,nproc,pid' initializes it. The local shards are every card
    # of this process, or ``devices`` shards on the CPU
    mh = os.environ.get('SEQWIN_TPU_MULTIHOST')
    if mh is not None:
        if mh not in ('', '1'):
            coord, nproc, pid = mh.rsplit(',', 2)
            multihost.initialize(coord, int(nproc), int(pid))
        return multihost.build_multihost(
            paths, kmerlen, windowsize, targets,
            _shard_devices(devices if dev.type == 'cpu' else 0, dev),
            n_cpu=n_cpu, low_memory=low_memory, defer=defer)
    if devices != 1:
        shards = _shard_devices(devices, dev)
        if len(shards) > 1:
            return build_distributed(paths, kmerlen, windowsize, targets, shards, n_cpu=n_cpu,
                                     defer=defer, low_memory=low_memory,
                                     keep_codes=keep_codes)
    use_sort_engine = os.environ.get('SEQWIN_TPU_TORCH_SCAN', 'hybrid') == 'sort'
    chunk_budget = LOW_MEMORY_CHUNK_BASES if low_memory else DEFAULT_CHUNK_BASES

    record_ids: list[tuple[str, ...]] = []
    record_offsets = [0]
    kept_codes: list[list[np.ndarray]] = []

    chunk_results = []  # (e_oh, e_pos, e_rec, count, e_asm) per chunk, scan order
    chunk_inputs = []   # (records, rec_base, pinned prep) of a deferred chunk, else None
    pending = deque()   # (future of the prep, records, rec_base), chunk order
    chunk_codes: list[np.ndarray] = []
    chunk_rec_base = 0
    chunk_bases = 0

    def dispatch(block: bool):
        """Dispatch the prepped chunks at the head of ``pending``, in chunk
        order; with ``block``, all of them."""
        while pending and (block or pending[0][0].done()):
            fut, recs, base = pending.popleft()
            if block:
                with timeline.span('build.prep_wait', rec_base=base):
                    prep = fut.result()
            else:
                prep = fut.result()  # done
            if not prep[0].numel():
                chunk_results.append((None, None, None, 0, None))
                chunk_inputs.append(None)
                continue
            with timeline.span('build.dispatch', rec_base=base):
                chunk_results.append(scan_chunk_deferred(prep, kmerlen, windowsize, base, dev))
            chunk_inputs.append((recs, base, prep))

    def flush():
        nonlocal chunk_codes, chunk_rec_base, chunk_bases
        if not chunk_codes:
            return
        offsets = np.array(record_offsets, dtype=np.uintp)
        if use_sort_engine:
            chunk_results.append(scan_chunk_sort(
                chunk_codes, kmerlen, windowsize, chunk_rec_base, record_offsets=offsets,
                device=dev))
            chunk_inputs.append(None)
        else:
            pending.append((prep_pool.submit(pinned_host_prep, chunk_codes, kmerlen, windowsize,
                                             chunk_rec_base, offsets, dev, timeline.current()),
                            chunk_codes, chunk_rec_base))
            dispatch(block=False)
        chunk_rec_base += len(chunk_codes)
        chunk_codes, chunk_bases = [], 0

    # files parse in worker threads, chunks prep in a pool of their own, and
    # the main thread dispatches each prepped chunk in chunk order while
    # later ones parse and prep
    assemblies = iter_assemblies(paths, n_cpu)
    prep_pool = ThreadPoolExecutor(max_workers=max(1, min(4, int(n_cpu))))
    ok = False
    try:
        while True:
            with timeline.span('build.ingest_wait'):
                item = next(assemblies, None)
            if item is None:
                break
            ids, codes_list = item
            record_ids.append(tuple(ids))
            record_offsets.append(record_offsets[-1] + len(ids))
            if keep_codes:
                kept_codes.append(codes_list)
            for codes in codes_list:
                if not use_sort_engine and len(codes) > chunk_budget:
                    # a record longer than the budget: its own halo'd blocks,
                    # in scan order after the chunk before it
                    flush()
                    dispatch(block=True)
                    with timeline.span('build.blocks', rec=chunk_rec_base, bases=len(codes)) as s:
                        blocks = scan_record_blocks(
                            codes, kmerlen, windowsize, chunk_rec_base, chunk_budget,
                            record_offsets=np.array(record_offsets, dtype=np.uintp), device=dev)
                        s.set(blocks=len(blocks))
                    chunk_results.extend(blocks)
                    chunk_inputs.extend([None] * len(blocks))
                    chunk_rec_base += 1
                    continue
                if chunk_bases + len(codes) > chunk_budget and chunk_codes:
                    flush()
                chunk_codes.append(codes)
                chunk_bases += len(codes)
            dispatch(block=False)
        flush()
        dispatch(block=True)
        ok = True
    finally:
        prep_pool.shutdown(wait=True, cancel_futures=not ok)

    offsets = np.array(record_offsets, dtype=np.uintp)
    if not use_sort_engine:
        # one batched fetch of every deferred count; a chunk whose count
        # passed its emission capacity is scanned again, exactly
        deferred = [i for i, inp in enumerate(chunk_inputs) if inp is not None]
        timeline.mark('counts_fetch_start', n_chunks=len(deferred))
        with timeline.span('build.counts_fetch', chunks=len(deferred)):
            counts = (torch.stack([chunk_results[i][3] for i in deferred]).tolist()
                      if deferred else [])
        timeline.mark('counts_fetched')
        for i, count in zip(deferred, counts):
            recs, base, _ = chunk_inputs[i]
            e_oh, e_pos, e_rec, _, e_asm = chunk_results[i]
            if count <= e_oh.numel():
                chunk_results[i] = (e_oh[:count], e_pos[:count], e_rec[:count], count,
                                    e_asm[:count])
            else:
                logger.debug(f'build: chunk at record {base} emitted {count} minimizers, above '
                             f'its capacity {e_oh.numel()}; scanning it again')
                counters['overflow_reruns'] += 1
                chunk_results[i] = scan_chunk_device(recs, kmerlen, windowsize, base,
                                                     record_offsets=offsets, device=dev)
        del chunk_inputs  # the pinned host buffers, now that every copy is done
    with timeline.span('build.aggregate'):
        res = aggregate_device(chunk_results, np.asarray(targets, dtype=bool), defer=defer)
    if not defer:
        kmers, nodes, edges = res
        return kmers, nodes, edges, offsets, record_ids
    if keep_codes:
        res.record_codes = kept_codes
    return res, offsets, record_ids


def _build_numpy(paths, kmerlen, windowsize, targets, oracle=False):
    """Device-free reference backends: the vectorized NumPy builder
    (`ops/host_build.py`, ``backend='numpy'``) or the per-position oracle
    (`ops/oracle.py`, ``backend='oracle'``, slow -- differential tests
    only). Returns (kmers, nodes, edges, record_offsets, record_ids, the
    parsed record codes per assembly)."""
    if oracle:
        from ..ops.oracle import build_graph
    else:
        from ..ops.host_build import build_graph_vec as build_graph

    record_ids: list[tuple[str, ...]] = []
    record_seqs: list[list[np.ndarray]] = []
    for p in paths:
        ids, codes_list = parse_fasta_codes(p)
        record_ids.append(tuple(ids))
        record_seqs.append(codes_list)
    kmers, nodes, edges, offsets = build_graph(record_seqs, kmerlen, windowsize, targets)
    return kmers, nodes, edges, offsets, record_ids, record_seqs


def kept_node_layout(
    nodes: np.ndarray, used_hashes
) -> tuple[np.ndarray, np.ndarray, int]:
    """Which nodes survive ``used_hashes`` and where their k-mers land.

    Returns (keep bool[len(nodes)], out_nodes with rebased start/stop,
    total kept k-mer entries). Shared by `filter_kmers` and the
    device-resident compaction (`engine.aggregate.DeviceGraph.compact_kmers`).
    """
    used = np.fromiter((int(h) for h in used_hashes), dtype=np.uint64)
    used.sort()
    keep = np.isin(nodes['hash'], used, assume_unique=False)
    kept_nodes = nodes[keep]
    sizes = (kept_nodes['stop'] - kept_nodes['start']).astype(np.int64)
    new_stops = np.cumsum(sizes)
    out_nodes = kept_nodes.copy()
    out_nodes['start'] = new_stops - sizes
    out_nodes['stop'] = new_stops
    total = int(new_stops[-1]) if len(kept_nodes) else 0
    return keep, out_nodes, total


def filter_kmers(
    kmers: np.ndarray, nodes: np.ndarray, used_hashes
) -> tuple[np.ndarray, np.ndarray]:
    """Keep only k-mers/nodes whose hash is in ``used_hashes``; rebase ranges."""
    keep, out_nodes, total = kept_node_layout(nodes, used_hashes)
    kept_nodes = nodes[keep]
    new_kmers = np.zeros(total, dtype=KMER_DTYPE)
    if total:
        # vectorized segment gather: within-segment offset + old segment start
        sizes = (kept_nodes['stop'] - kept_nodes['start']).astype(np.int64)
        old_starts = kept_nodes['start'].astype(np.int64)
        new_starts = out_nodes['start'].astype(np.int64)
        seg_idx = (np.arange(total, dtype=np.int64)
                   + np.repeat(old_starts - new_starts, sizes))
        new_kmers = kmers[seg_idx]
    return new_kmers, out_nodes
