"""Multi-host graph build: per-process parsing, one build over the shards
of every process, a host merge.

Counterpart: `seqwin_tpu/parallel/multihost.py` (`initialize`,
`partition_indices`, `partition_paths`, `_allgather_ragged_i64`,
`exchange_record_counts`, `exchange_record_ids`, `_size_batches`,
`build_multihost`), on `torch.distributed` with the gloo backend:

- every process calls `initialize()` and joins one process group; its
  local shards are its cards (or CPU shards);
- assemblies are partitioned contiguously across processes by file size,
  and each process parses only its own;
- per-assembly record counts and record ids are all-gathered, so every
  process knows the global record index space;
- `distributed.build_distributed_arrays` builds over the shards of all
  processes (hash buckets owned by another process's shards travel by
  `all_to_all_single`) and hands every process the whole arrays.

A single process reduces to `build_distributed_arrays` over its own shards,
without a collective.
"""
from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np
import torch.distributed as dist

from ..engine import timeline
from ..engine.aggregate import HostGraph
from ..graph.dtypes import EDGE_DTYPE, KMER_DTYPE, NODE_DTYPE
from ..io.fasta import iter_assemblies
from .distributed import (
    _allgather_ragged,
    _multiprocess,
    _process_shards,
    build_distributed_arrays,
    merge_graph_parts,
)

logger = logging.getLogger(__name__)


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the gloo process group at ``coordinator_address`` (host:port) as
    rank ``process_id`` of ``num_processes`` (no-op for one process, or when
    this process already joined that group)."""
    if num_processes is None or num_processes <= 1:
        return
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (num_processes, process_id):
            raise ValueError(
                f'process group already initialized as rank {dist.get_rank()} of '
                f'{dist.get_world_size()}, not {process_id} of {num_processes}')
        return
    dist.init_process_group('gloo', init_method=f'tcp://{coordinator_address}',
                            world_size=num_processes, rank=process_id)


def _world() -> tuple[int, int]:
    """(number of processes, this process's rank)."""
    return (dist.get_world_size(), dist.get_rank()) if _multiprocess() else (1, 0)


def partition_indices(sizes: list[int], n_parts: int, part: int) -> list[int]:
    """Contiguous, load-balanced index partition (the rule of the device
    partition `distributed.partition_records`, but advancing only once the
    running total passes a share)."""
    total = sum(sizes)
    budget = total / n_parts if n_parts else 0
    out = []
    acc = 0
    p = 0
    for i, s in enumerate(sizes):
        if acc > budget * (p + 1) and p < n_parts - 1:
            p += 1
        if p == part:
            out.append(i)
        acc += s
    return out


def partition_paths(paths: list, sizes: list[int], n_processes: int, process_id: int) -> list:
    """Contiguous, load-balanced partition of assembly files across processes."""
    return [paths[i] for i in partition_indices(sizes, n_processes, process_id)]


def _allgather_ragged_i64(vec) -> list[np.ndarray]:
    """Every process's int64 vector, in process order."""
    return _allgather_ragged(np.asarray(vec, dtype=np.int64))


def exchange_record_counts(local_counts, n_processes: int) -> np.ndarray:
    """Each process's per-assembly record counts, concatenated in process
    order: the global per-assembly counts (the partitions are contiguous)."""
    if n_processes <= 1:
        return np.asarray(local_counts, dtype=np.int64)
    return np.concatenate(_allgather_ragged_i64(local_counts))


def exchange_record_ids(my_ids: list[tuple[str, ...]], n_processes: int) -> list[tuple[str, ...]]:
    """Every process's per-assembly record-id tuples, in assembly order."""
    if n_processes <= 1:
        return list(my_ids)
    payload = np.frombuffer(json.dumps([list(t) for t in my_ids]).encode(), dtype=np.uint8)
    return [tuple(ids) for part in _allgather_ragged(payload)
            for ids in json.loads(part.tobytes().decode())]


def _size_batches(paths: list[str], sizes: list[int], budget: int):
    """Consecutive whole-assembly batches of estimated bases reaching
    ``budget`` (the estimate is the file size, x3 for gzip). Every process
    derives the same batches from the global path list, so the batches'
    collectives line up without a message."""
    est = [s * 3 if p.endswith('.gz') else s for p, s in zip(paths, sizes)]
    batches: list[tuple[int, int]] = []
    lo, acc = 0, 0
    for i, e in enumerate(est):
        acc += int(e)
        if acc >= budget:
            batches.append((lo, i + 1))
            lo, acc = i + 1, 0
    if lo < len(paths):
        batches.append((lo, len(paths)))
    return batches


def build_multihost(assembly_paths, kmerlen: int, windowsize: int, is_targets, devices,
                    n_cpu: int = 1, low_memory: bool = False, defer: bool = False):
    """Multi-host graph build over the local ``devices`` (torch devices, one
    per shard) of every process of the group (`initialize`; one process
    without it). Same output contract and bytes as `graph.build`, on every
    process: (kmers, nodes, edges, record_offsets, record_ids), or with
    ``defer`` (`engine.aggregate.HostGraph`, record_offsets, record_ids)
    whose ``n_chunks`` counts this process's shard streams with bases.

    ``low_memory`` builds consecutive whole-assembly batches of about
    (all shards) x ``LOW_MEMORY_CHUNK_BASES`` estimated bases
    (`_size_batches`); each batch is partitioned across the processes,
    built, and the parts merge on the host (`merge_graph_parts`)."""
    from ..graph.build import LOW_MEMORY_CHUNK_BASES  # read at call time

    paths = [str(p) for p in assembly_paths]
    targets = [bool(t) for t in is_targets]
    nproc, pid = _world()
    sizes = [Path(p).stat().st_size for p in paths]
    if low_memory:
        n_shards = sum(_process_shards(len(devices)))
        batches = _size_batches(paths, sizes, n_shards * LOW_MEMORY_CHUNK_BASES)
    else:
        batches = [(0, len(paths))] if paths else []

    parts = []
    all_ids: list[tuple[str, ...]] = []
    offsets_list = [0]
    for lo, hi in batches:
        mine = partition_indices(sizes[lo:hi], nproc, pid)
        logger.info(f'process {pid}/{nproc}: parsing {len(mine)}/{hi - lo} assemblies '
                    f'(batch {lo}:{hi})')
        my_counts, my_ids, my_codes = [], [], []
        with timeline.span('multihost.parse'):
            for ids, codes_list in iter_assemblies([paths[lo + i] for i in mine], n_cpu):
                my_counts.append(len(ids))
                my_ids.append(tuple(ids))
                my_codes.extend(codes_list)
        batch_counts = exchange_record_counts(my_counts, nproc)
        # global record index of this process's first record of the batch
        first_asm = mine[0] if mine else len(batch_counts)
        base = offsets_list[-1]
        rec_base0 = base + int(np.sum(batch_counts[:first_asm]))
        offsets_list.extend((base + np.cumsum(batch_counts)).tolist())
        parts.append(build_distributed_arrays(
            my_codes, np.asarray(offsets_list, dtype=np.uintp), targets, kmerlen, windowsize,
            devices, rec_base0=rec_base0))
        all_ids.extend(exchange_record_ids(my_ids, nproc))

    if parts:
        kmers, nodes, edges = merge_graph_parts([p[:3] for p in parts])
    else:
        kmers = np.zeros(0, dtype=KMER_DTYPE)
        nodes = np.zeros(0, dtype=NODE_DTYPE)
        edges = np.zeros(0, dtype=EDGE_DTYPE)
    offsets = np.asarray(offsets_list, dtype=np.uintp)
    if nproc > 1:
        dist.barrier()
    if defer:
        return HostGraph(kmers, nodes, edges, n_chunks=sum(p[3] for p in parts)), offsets, all_ids
    return kmers, nodes, edges, offsets, all_ids
