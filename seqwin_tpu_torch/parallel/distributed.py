"""Single-host multi-device graph build: every shard scans its contiguous
records, routes its emissions and adjacency pairs to their hash-bucket
owners, and each owner reduces its bucket.

Counterpart: `seqwin_tpu/parallel/distributed.py` (`_hash_bucket`,
`_pair_boundaries`, `_pair_bucket`, `_pair_bucket_host`, `_route_blocks`,
`_exchange`, `_count_step`, `_shard_step`, `partition_records`,
`_shard_layout`, `build_distributed_arrays`, `build_distributed`). Where the
JAX package runs one shard_map program over a device mesh, the port takes a
list of torch devices, one per shard; a device may appear more than once.

1. **Host prep**: a contiguous, load-balanced record partition, and per
   shard the augmented byte stream, record starts and irregular-window
   patches, each sized to the shard's own records (no shared padded shape).
2. **Count pre-pass** (kernel B2, `phase1_zc`): per shard the exact emission
   count, the clean-only count, and the per-destination histograms of
   minimizers and adjacency pairs. The host enqueues every shard's pre-pass
   without waiting on the device, then reads the results.
3. **Build step** (kernel B3, `phase1_pfx`): pfx extraction into exactly
   sized streams, adjacency pairs at the source, one stable sort by bucket
   and a split by the pre-pass histograms, then a copy to each owner, which
   concatenates the blocks in source order. Nothing in the step waits on
   the device, so the host enqueues every shard's work before any ends;
   the device's own counts are checked against the pre-pass after the
   merge.
4. **Owner merge** (`aggregate._merge_nodes`, `aggregate._reduce_edges`) and
   concatenation in owner order: the hash space is range-partitioned
   monotonically, so the owners' outputs concatenate into the globally
   sorted arrays, byte-equal to the single-device build.

Not ported here, each raising `NotImplementedError` with its ROADMAP item:
records above the per-shard sequence budget (sequence sharding, A8) and
multi-host builds (A13); `low_memory` is refused by `graph.build` (A8).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.profiler import record_function

from ..engine.aggregate import (
    HostGraph,
    _edges_host,
    _kmers_host,
    _merge_nodes,
    _nodes_host,
    _reduce_edges,
)
from ..engine.hybrid import (
    _cummax_rows,
    _emission_mask,
    chunk_host_prep,
    out_hash,
    scan_phase2_pfx,
)
from ..engine.phase1 import _shift_right, phase1_pfx, phase1_zc
from ..io.fasta import iter_assemblies
from ..graph.dtypes import EDGE_DTYPE, KMER_DTYPE, NODE_DTYPE
from ..ops import u64


def _bucket_counts(bucket, n_dev: int):
    """Entries in each bucket 0..n_dev-1, int64[n_dev] (bucket n_dev, the
    dead entries, is not counted). One compare per bucket id and a column
    sum: `torch.bincount` reads its input's range back to the host on a
    CUDA device, and this queues without a sync."""
    return (bucket[:, None] == torch.arange(n_dev, device=bucket.device)).sum(0)


def _hash_bucket(oh, live, n_dev: int):
    """Monotone range partition of the hash space into n_dev buckets
    (dead entries -> bucket n_dev)."""
    hi32 = u64.shr(oh, 32)
    return torch.where(live, (hi32 * n_dev) >> 32, n_dev)


@functools.lru_cache(maxsize=None)
def _pair_boundaries(n_dev: int) -> tuple[int, ...]:
    """Equal-mass partition boundaries (top-32-bit space) for the edge-pair
    routing key ``min(u, v)`` of two ~iid uniform out-hashes, whose density
    is 2(1-x): the d-th boundary is 2^32 * (1 - sqrt(1 - d/n)). Any monotone
    boundaries keep the owner concatenation hash-sorted."""
    d = np.arange(1, n_dev, dtype=np.float64)
    return tuple(np.ceil((1.0 - np.sqrt(1.0 - d / n_dev)) * 2.0**32)
                 .astype(np.int64).tolist())


def _pair_bucket(pu, live, n_dev: int):
    """`_hash_bucket` for edge pairs with the `_pair_boundaries` splits
    (dead entries -> bucket n_dev)."""
    if n_dev == 1:
        return torch.where(live, 0, 1)
    # the number of boundaries at or below hi32 (a right-side searchsorted),
    # with the boundaries as host scalars: no copy to the device
    hi32 = u64.shr(pu, 32)
    return torch.where(live, sum((hi32 >= b).long() for b in _pair_boundaries(n_dev)), n_dev)


def _pair_bucket_host(pu: np.ndarray, n_dev: int) -> np.ndarray:
    """Host twin of `_pair_bucket` for uint64 keys (all entries live)."""
    hi32 = (pu >> np.uint64(32)).astype(np.int64)
    b = np.asarray(_pair_boundaries(n_dev), dtype=np.int64)
    return np.searchsorted(b, hi32, side='right')


def partition_records(record_lengths, n_dev: int):
    """Contiguous, load-balanced record partition (the reference's
    base+remainder thread split). Returns the shard of each record."""
    total = int(sum(record_lengths))
    budget = total / n_dev if n_dev else 0
    out = np.zeros(len(record_lengths), dtype=np.int32)
    acc = 0
    d = 0
    for i, n in enumerate(record_lengths):
        # advance once the running total REACHES this shard's share
        if acc >= budget * (d + 1) and d < n_dev - 1:
            d += 1
        out[i] = d
        acc += int(n)
    return out


def _shard_layout(record_codes, shard_of, devices, k: int, w: int, record_offsets):
    """Host prep per shard, sized to its own records. Returns one entry per
    shard: a dict of device tensors (codes, starts, patch_pos, patch_z,
    asm_tab) plus its rec_base, or None for a shard without bases."""
    shards = []
    rec_base = 0
    for d, dev in enumerate(devices):
        recs = [c for c, s in zip(record_codes, shard_of) if s == d]
        total = sum(len(c) for c in recs)
        if total >= 1 << 31:  # phase 1 writes stream positions as int32
            raise NotImplementedError(
                f'shard {d} holds {total} bases, past int32 stream positions: '
                'ROADMAP queue A8 (long inputs)')
        if total:
            codes, starts, irr_pos, patch_z, asm_tab = chunk_host_prep(
                recs, k, w, rec_base, record_offsets)
            shards.append(dict(
                rec_base=rec_base,
                **{name: torch.from_numpy(a).to(dev, non_blocking=True) for name, a in (
                    ('codes', codes), ('starts', starts), ('patch_pos', irr_pos),
                    ('patch_z', patch_z), ('asm_tab', asm_tab))}))
        else:
            shards.append(None)
        rec_base += len(recs)
    return shards


def _count_step(codes, starts, patch_pos, patch_z, k: int, w: int, n_dev: int):
    """Count pre-pass of one shard on kernel B2: (count, clean_count,
    e_hist int64[n_dev], p_hist int64[n_dev]), device tensors.

    Both histograms bucket the out-hash at the minimizer position z[p] (the
    hash the build step routes), not at the flag position p."""
    z_clean, canon = phase1_zc(codes, k, w)
    z = z_clean.clone()
    z[patch_pos.long()] = patch_z
    emit = _emission_mask(z)
    ohz = out_hash(canon, k)[z.long().clamp(min=0)]
    # adjacency pairs = consecutive emissions of one record: the previous
    # emission of each position is a running max over emitting indices
    iota = torch.arange(z.numel(), device=z.device)
    prev = _shift_right(_cummax_rows(torch.where(emit, iota, -1)), 1, -1)
    prev_c = prev.clamp(min=0)
    rec_local = torch.searchsorted(starts, iota, right=True)
    pair_ok = emit & (prev >= 0) & (rec_local == rec_local[prev_c])
    p_u = u64.umin(ohz, ohz[prev_c])
    e_hist = _bucket_counts(_hash_bucket(ohz, emit, n_dev), n_dev)
    p_hist = _bucket_counts(_pair_bucket(p_u, pair_ok, n_dev), n_dev)
    return emit.sum(), _emission_mask(z_clean).sum(), e_hist, p_hist


def _route_blocks(bucket, payloads, sizes: list[int]):
    """Per-destination blocks: one stable sort by bucket (scan order within
    a bucket), split by the host-known ``sizes``. Returns (blocks, counts):
    blocks[i][d] is payload i's block for destination d, and ``counts`` the
    device's own bucket counts, which should equal ``sizes``."""
    order = torch.sort(bucket, stable=True).indices[:sum(sizes)]
    blocks = [torch.split(p[order], sizes) for p in payloads]
    return blocks, _bucket_counts(bucket, len(sizes))


def _exchange(blocks, devices):
    """Copy each destination's block to its device (no copy when it is
    already there)."""
    return [[b.to(dev, non_blocking=True) for b, dev in zip(per_dest, devices)]
            for per_dest in blocks]


def _route_shard(e_oh, e_pos, e_rec, e_asm, e_sizes: list[int], p_sizes: list[int], devices):
    """Adjacency pairs at the source, routing and exchange of one shard's
    emission streams. Returns the node blocks (oh, pos, rec, asm) and pair
    blocks (u, v, asm), each a list over owners on the owner's device, and
    the device's own counts of both per owner."""
    n_dev = len(devices)
    pair_ok = e_rec[:-1] == e_rec[1:]
    a, b = e_oh[:-1], e_oh[1:]
    p_u = u64.umin(a, b)
    node_blocks, e_counts = _route_blocks(
        _hash_bucket(e_oh, torch.ones_like(e_rec, dtype=torch.bool), n_dev),
        (e_oh, e_pos, e_rec, e_asm), e_sizes)
    pair_blocks, p_counts = _route_blocks(
        _pair_bucket(p_u, pair_ok, n_dev), (p_u, u64.umax(a, b), e_asm[:-1]), p_sizes)
    return (_exchange(node_blocks, devices), _exchange(pair_blocks, devices),
            e_counts, p_counts)


def _shard_step(shard, k: int, w: int, emit_cap: int, count: int,
                e_sizes: list[int], p_sizes: list[int], devices):
    """Build step of one shard on kernel B3: pfx extraction, then
    `_route_shard`. Returns the node and pair blocks and the shard's checks,
    {name: (device tensor, the value the pre-pass expects)}."""
    zpfx, lrank, _ = phase1_pfx(shard['codes'], k, w)
    e_oh, e_pos, e_rec, dev_count, e_asm = scan_phase2_pfx(
        zpfx, lrank, shard['codes'], shard['patch_pos'], shard['patch_z'],
        shard['starts'], shard['rec_base'], shard['asm_tab'], emit_cap, count, k)
    node_blocks, pair_blocks, e_counts, p_counts = _route_shard(
        e_oh, e_pos, e_rec, e_asm, e_sizes, p_sizes, devices)
    checks = {'emission counts': (dev_count, count),
              'minimizer block sizes': (e_counts, e_sizes),
              'pair block sizes': (p_counts, p_sizes)}
    return node_blocks, pair_blocks, checks


def _prepass(shards, k: int, w: int, n_dev: int):
    """Enqueue the count pre-pass of every shard (no sync); one tuple of
    device tensors per shard, None for a shard without bases."""
    return [None if s is None else _count_step(
        s['codes'], s['starts'], s['patch_pos'], s['patch_z'], k, w, n_dev) for s in shards]


def _read_prepass(pre, n_dev: int):
    """The host's read of the pre-pass: per shard (count, clean), and the
    minimizer and pair histograms, int64[n_shards, n_dev] each."""
    zeros = np.zeros(n_dev, np.int64)
    counts = [(int(p[0]), int(p[1])) if p else (0, 0) for p in pre]
    e_hist = np.stack([p[2].cpu().numpy() if p else zeros for p in pre])
    p_hist = np.stack([p[3].cpu().numpy() if p else zeros for p in pre])
    return counts, e_hist, p_hist


def _step(shards, k: int, w: int, counts, e_hist, p_hist, devices):
    """Enqueue the build step of every shard in source order (no sync), so
    each owner receives its blocks in scan order. Returns the blocks each
    owner received, per source, and the checks (name, shard, device
    tensor, expected)."""
    n_dev = len(devices)
    rx_nodes = [[] for _ in range(n_dev)]
    rx_pairs = [[] for _ in range(n_dev)]
    checks = []
    for d, s in enumerate(shards):
        if s is None:
            continue
        count, clean = counts[d]
        node_blocks, pair_blocks, shard_checks = _shard_step(
            s, k, w, max(count, clean), count, e_hist[d].tolist(), p_hist[d].tolist(), devices)
        for j in range(n_dev):
            rx_nodes[j].append([b[j] for b in node_blocks])
            rx_pairs[j].append([b[j] for b in pair_blocks])
        checks += [(name, d, got, want) for name, (got, want) in shard_checks.items()]
    return rx_nodes, rx_pairs, checks


def _check_step(checks) -> None:
    """Raise when a device count of the step differs from the pre-pass."""
    for name, d, got, want in checks:
        if not np.array_equal(got.cpu().numpy(), np.asarray(want)):
            raise RuntimeError(
                f'multi-device build: shard {d}: {name} disagree with the count '
                'pre-pass (the pre-pass and the build step diverged)')


def build_distributed_arrays(record_codes: list[np.ndarray], record_offsets,
                             is_target, kmerlen: int, windowsize: int, devices):
    """Multi-device build from parsed records over ``devices`` (a list of
    torch devices, one per shard, repeats allowed). Returns (kmers, nodes,
    edges, n_scanned): the structured arrays, byte-equal to the
    single-device build, and the number of shards that held bases (one
    kernel B2 and one kernel B3 launch each)."""
    devices = [torch.device(d) for d in devices]
    n_dev = len(devices)
    k, w = kmerlen, windowsize
    lengths = [len(c) for c in record_codes]
    seq_budget = max(1 << 16, -(-2 * int(sum(lengths)) // n_dev))
    if n_dev > 1 and any(ln > seq_budget for ln in lengths):
        raise NotImplementedError(
            f'a record above the per-shard sequence budget ({seq_budget} bases): '
            'ROADMAP queue A8 (sequence sharding of long records)')
    shards = _shard_layout(record_codes, partition_records(lengths, n_dev),
                           devices, k, w, record_offsets)

    with record_function('distributed.prepass'):
        counts, e_hist, p_hist = _read_prepass(_prepass(shards, k, w, n_dev), n_dev)
    with record_function('distributed.step'):
        rx_nodes, rx_pairs, checks = _step(shards, k, w, counts, e_hist, p_hist, devices)

    # --- owner merge, concatenated in owner order ---
    tmask = np.asarray(is_target, dtype=bool)
    kmers, nodes, edges = [], [], []
    base = 0
    with record_function('distributed.merge'):
        for j, dev in enumerate(devices):
            if e_hist[:, j].sum():
                oh, pos, rec, asm = (torch.cat(c) for c in zip(*rx_nodes[j]))
                s_pos, s_rec, node_hash, starts, stops, n_tar, n_neg = _merge_nodes(
                    oh, pos, rec, asm, torch.from_numpy(tmask).to(dev))
                kmers.append(_kmers_host(s_pos, s_rec))
                nodes.append(_nodes_host(node_hash, starts, stops, n_tar, n_neg, base))
                base += s_pos.numel()
            if p_hist[:, j].sum():
                u, v, asm = (torch.cat(c) for c in zip(*rx_pairs[j]))
                edges.append(_edges_host(*_reduce_edges(u, v, asm)))
    _check_step(checks)
    return (np.concatenate(kmers or [np.zeros(0, KMER_DTYPE)]),
            np.concatenate(nodes or [np.zeros(0, NODE_DTYPE)]),
            np.concatenate(edges or [np.zeros(0, EDGE_DTYPE)]),
            sum(s is not None for s in shards))


def build_distributed(assembly_paths, kmerlen: int, windowsize: int, is_targets,
                      devices, n_cpu: int = 1, defer: bool = False):
    """Multi-device graph build over ``devices`` (torch devices, one per
    shard, repeats allowed). Same output contract and bytes as
    `graph.build`: (kmers, nodes, edges, record_offsets, record_ids), or
    with ``defer`` (graph, record_offsets, record_ids) where ``graph`` is an
    `engine.aggregate.HostGraph` whose ``n_chunks`` counts the shards that
    held bases."""
    paths = [str(p) for p in assembly_paths]
    targets = [bool(t) for t in is_targets]
    record_ids: list[tuple[str, ...]] = []
    record_offsets = [0]
    record_codes: list[np.ndarray] = []
    for ids, codes_list in iter_assemblies(paths, n_cpu):
        record_ids.append(tuple(ids))
        record_offsets.append(record_offsets[-1] + len(ids))
        record_codes.extend(codes_list)
    offsets = np.array(record_offsets, dtype=np.uintp)
    kmers, nodes, edges, n_scanned = build_distributed_arrays(
        record_codes, offsets, targets, kmerlen, windowsize, devices)
    if defer:
        return HostGraph(kmers, nodes, edges, n_chunks=n_scanned), offsets, record_ids
    return kmers, nodes, edges, offsets, record_ids
