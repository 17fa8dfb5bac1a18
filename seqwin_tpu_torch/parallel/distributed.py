"""Single-host multi-device graph build: every shard scans its contiguous
records, routes its emissions and adjacency pairs to their hash-bucket
owners, and each owner reduces its bucket.

Counterpart: `seqwin_tpu/parallel/distributed.py` (`_hash_bucket`,
`_pair_boundaries`, `_pair_bucket`, `_pair_bucket_host`, `_route_blocks`,
`_exchange`, `_count_step`, `_shard_step`, `partition_records`,
`_shard_layout`, `_assign_with_oversized`, `scan_record_sharded`,
`build_distributed_arrays`, `merge_graph_parts`, `build_distributed`).
Where the JAX package runs one shard_map program over a device mesh, the
port takes a list of torch devices, one per shard; a device may appear more
than once.

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

A record above the per-shard sequence budget (twice the balanced share) is
sequence-sharded: `scan_record_sharded` splits it into at most one halo'd
block per shard (`engine/hybrid.scan_blocks`, kernel B1 and the mask
extraction on each), and its emission stream joins the routing of the shard
it terminates (`_assign_with_oversized`), after that shard's own stream.
``low_memory`` builds batches of whole assemblies of at least
``len(devices) * LOW_MEMORY_CHUNK_BASES`` bases one after another and merges
them on the host (`merge_graph_parts`).

Across the processes of a `torch.distributed` group (gloo; the multi-host
build, `parallel/multihost.py`) the shards are every process's local shards
in rank order and the hash buckets range over all of them. The pre-pass
reads are all-gathered on the host, a block bound for another process's
owner travels by `all_to_all_single` on host-staged tensors (its size is in
the gathered histograms), and each owner's arrays are gathered back in owner
order. Records are not sequence-sharded there. A single process takes none
of these collectives.
"""
from __future__ import annotations

import functools
import logging

import numpy as np
import torch
import torch.distributed as dist

from ..engine import timeline
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
    _record_block_plan,
    chunk_host_prep,
    out_hash,
    scan_blocks,
    scan_phase2_pfx,
)
from ..engine.phase1 import _shift_right, phase1_pfx, phase1_zc
from ..io.fasta import iter_assemblies
from ..graph.dtypes import EDGE_DTYPE, KMER_DTYPE, NODE_DTYPE
from ..ops import u64

logger = logging.getLogger(__name__)


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


def _assign_with_oversized(lengths, over: set, n_dev: int):
    """Contiguous shard assignment where every oversized record TERMINATES
    its shard (its pre-scanned emissions are routed after the shard's own
    stream, so no later record may share the shard). Returns the shard of
    each record, or None when infeasible (a record follows an oversized
    record on the already-last shard)."""
    shard_of = np.zeros(len(lengths), dtype=np.int32)
    norm_total = sum(ln for i, ln in enumerate(lengths) if i not in over)
    target = norm_total / n_dev if n_dev else 0
    d, acc, closed = 0, 0, False
    glob_acc = 0
    for i, ln in enumerate(lengths):
        if i in over:
            shard_of[i] = d
            closed = True
            continue
        if closed:
            if d >= n_dev - 1:
                return None
            d += 1
            closed = False
        # >= like partition_records: the strict test leaves one extra record
        # per shard with equal-size records
        elif acc > 0 and glob_acc >= target * (d + 1) and d < n_dev - 1:
            d += 1
            acc = 0
        shard_of[i] = d
        acc += int(ln)
        glob_acc += int(ln)
    return shard_of


def _shard_layout(record_codes, shard_of, devices, k: int, w: int, record_offsets,
                  rec_index=None):
    """Host prep per shard, sized to its own records. ``rec_index`` is the
    global index of each record (default: its position in
    ``record_codes``); a shard's records are consecutive in it. Returns one
    entry per shard: a dict of device tensors (codes, starts, patch_pos,
    patch_z, asm_tab) plus its rec_base, or None for a shard without
    bases."""
    if rec_index is None:
        rec_index = np.arange(len(record_codes))
    shards = []
    for d, dev in enumerate(devices):
        mine = np.flatnonzero(np.asarray(shard_of) == d)
        recs = [record_codes[i] for i in mine]
        total = sum(len(c) for c in recs)
        if total >= 1 << 31:  # phase 1 writes stream positions as int32
            raise ValueError(
                f'shard {d} holds {total} bases, past int32 stream positions; '
                'low_memory builds the input in smaller batches')
        if total:
            rec_base = int(rec_index[mine[0]])
            codes, starts, irr_pos, patch_z, asm_tab = chunk_host_prep(
                recs, k, w, rec_base, record_offsets)
            shards.append(dict(
                rec_base=rec_base,
                **{name: torch.from_numpy(a).to(dev, non_blocking=True) for name, a in (
                    ('codes', codes), ('starts', starts), ('patch_pos', irr_pos),
                    ('patch_z', patch_z), ('asm_tab', asm_tab))}))
        else:
            shards.append(None)
    return shards


def sharded_block_plan(codes: np.ndarray, k: int, w: int, n_dev: int):
    """The block plan of a sequence-sharded record: `_record_block_plan`
    with the budget grown x1.3 from an even split until the plan has at
    most ``n_dev`` blocks (None: scan the record whole)."""
    budget = max(1 << 12, -(-len(codes) // n_dev))
    plan = _record_block_plan(codes, k, w, budget)
    while plan is not None and len(plan) > n_dev:
        budget = int(budget * 1.3)
        plan = _record_block_plan(codes, k, w, budget)
    return plan


def scan_record_sharded(codes: np.ndarray, k: int, w: int, devices, rec_idx: int,
                        record_offsets, out_device):
    """Scan ONE record split across ``devices``: block d of
    `sharded_block_plan` with kernel B1 on ``devices[d]``, the carry of the
    earlier blocks resolved on the host. Returns the record's emission
    streams (oh, pos, rec, asm) on ``out_device``, equal to the scan of the
    whole record, or None when it emits nothing."""
    codes = np.asarray(codes)
    plan = sharded_block_plan(codes, k, w, len(devices))
    blocks = [b for b in scan_blocks(codes, plan, k, w, rec_idx, record_offsets, devices)
              if b[3]]
    if not blocks:
        return None
    return tuple(torch.cat([b[i].to(out_device) for b in blocks]) for i in (0, 1, 2, 4))


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


def _stream_hists(e_oh, e_rec, n_dev: int):
    """Minimizer and adjacency-pair histograms of an exact-length emission
    stream (a sequence-sharded record's), as the pre-pass counts them."""
    e_hist = _bucket_counts(_hash_bucket(e_oh, torch.ones_like(e_rec, dtype=torch.bool), n_dev),
                            n_dev)
    p_hist = _bucket_counts(_pair_bucket(u64.umin(e_oh[:-1], e_oh[1:]), e_rec[:-1] == e_rec[1:],
                                         n_dev), n_dev)
    return e_hist, p_hist


def _route_blocks(bucket, payloads, sizes: list[int]):
    """Per-destination blocks: one stable sort by bucket (scan order within
    a bucket), split by the host-known ``sizes``. Returns (blocks, counts):
    blocks[i][d] is payload i's block for destination d, and ``counts`` the
    device's own bucket counts, which should equal ``sizes``."""
    order = torch.sort(bucket, stable=True).indices[:sum(sizes)]
    blocks = [torch.split(p[order], sizes) for p in payloads]
    return blocks, _bucket_counts(bucket, len(sizes))


def _route_shard(e_oh, e_pos, e_rec, e_asm, e_sizes: list[int], p_sizes: list[int]):
    """Adjacency pairs at the source and routing of one shard's emission
    streams to the ``len(e_sizes)`` owners. Returns the node blocks (oh,
    pos, rec, asm) and pair blocks (u, v, asm), each a list over owners on
    the shard's device, and the device's own counts of both per owner."""
    n_dev = len(e_sizes)
    pair_ok = e_rec[:-1] == e_rec[1:]
    a, b = e_oh[:-1], e_oh[1:]
    p_u = u64.umin(a, b)
    node_blocks, e_counts = _route_blocks(
        _hash_bucket(e_oh, torch.ones_like(e_rec, dtype=torch.bool), n_dev),
        (e_oh, e_pos, e_rec, e_asm), e_sizes)
    pair_blocks, p_counts = _route_blocks(
        _pair_bucket(p_u, pair_ok, n_dev), (p_u, u64.umax(a, b), e_asm[:-1]), p_sizes)
    return node_blocks, pair_blocks, e_counts, p_counts


def _shard_step(shard, k: int, w: int, emit_cap: int, count: int,
                e_sizes: list[int], p_sizes: list[int], extra=None):
    """Build step of one shard on kernel B3: pfx extraction, the
    sequence-sharded records' streams it terminates (``extra``) after it,
    then `_route_shard`. Returns the node and pair blocks (on the shard's
    device) and the shard's checks, {name: (device tensor, the value the
    pre-pass expects)}."""
    streams, checks = [], {}
    if shard is not None:
        zpfx, lrank, _ = phase1_pfx(shard['codes'], k, w)
        e_oh, e_pos, e_rec, dev_count, e_asm = scan_phase2_pfx(
            zpfx, lrank, shard['codes'], shard['patch_pos'], shard['patch_z'],
            shard['starts'], shard['rec_base'], shard['asm_tab'], emit_cap, count, k)
        streams.append((e_oh, e_pos, e_rec, e_asm))
        checks['emission counts'] = (dev_count, count)
    if extra is not None:
        streams.append(extra)
    node_blocks, pair_blocks, e_counts, p_counts = _route_shard(
        *(torch.cat(c) for c in zip(*streams)), e_sizes, p_sizes)
    checks.update({'minimizer block sizes': (e_counts, e_sizes),
                   'pair block sizes': (p_counts, p_sizes)})
    return node_blocks, pair_blocks, checks


def _prepass(shards, k: int, w: int, n_dev: int, extras=None):
    """Enqueue the count pre-pass of every shard (no sync); one tuple of
    device tensors per shard, None for a shard without bases or extras.
    The histograms of the sequence-sharded streams a shard terminates
    (``extras``) add to its own."""
    out = []
    for d, s in enumerate(shards):
        pre = None if s is None else _count_step(
            s['codes'], s['starts'], s['patch_pos'], s['patch_z'], k, w, n_dev)
        x = extras[d] if extras else None
        if x is not None:
            x_e, x_p = _stream_hists(x[0], x[2], n_dev)
            zero = torch.zeros((), dtype=torch.int64, device=x_e.device)
            pre = (zero, zero, x_e, x_p) if pre is None else (*pre[:2], pre[2] + x_e, pre[3] + x_p)
        out.append(pre)
    return out


def _read_prepass(pre, n_dev: int):
    """The host's read of the pre-pass: per shard (count, clean), and the
    minimizer and pair histograms, int64[n_shards, n_dev] each."""
    zeros = np.zeros(n_dev, np.int64)
    counts = [(int(p[0]), int(p[1])) if p else (0, 0) for p in pre]
    e_hist = np.stack([p[2].cpu().numpy() if p else zeros for p in pre])
    p_hist = np.stack([p[3].cpu().numpy() if p else zeros for p in pre])
    return counts, e_hist, p_hist


def _step(shards, k: int, w: int, counts, e_hist, p_hist, devices, extras=None,
          first: int = 0):
    """Enqueue the build step of every local shard in source order (no
    sync) and copy each block bound for a local owner to its device, so
    each owner receives its blocks in scan order. ``first`` is the global
    index of this process's first shard; ``counts`` and the histograms
    cover every shard of every process. Returns the blocks each local owner
    received, per source; the shards' blocks (global source, node blocks,
    pair blocks) when owners of other processes need them
    (`_exchange_across`), else None; and the checks (name, shard, device
    tensor, expected)."""
    rx_nodes = [[] for _ in devices]
    rx_pairs = [[] for _ in devices]
    sent = [] if e_hist.shape[1] > len(devices) else None
    checks = []
    for d, s in enumerate(shards):
        x = extras[d] if extras else None
        if s is None and x is None:
            continue
        g = first + d
        count, clean = counts[g]
        node_blocks, pair_blocks, shard_checks = _shard_step(
            s, k, w, max(count, clean), count, e_hist[g].tolist(), p_hist[g].tolist(), x)
        for j, dev in enumerate(devices):
            rx_nodes[j].append([b[first + j].to(dev, non_blocking=True) for b in node_blocks])
            rx_pairs[j].append([b[first + j].to(dev, non_blocking=True) for b in pair_blocks])
        if sent is not None:
            sent.append((g, node_blocks, pair_blocks))
        checks += [(name, g, got, want) for name, (got, want) in shard_checks.items()]
    return rx_nodes, rx_pairs, sent, checks


def _allgather_ragged(a: np.ndarray) -> list[np.ndarray]:
    """Every process's 1-D array ``a`` (one dtype on all of them, any
    numpy dtype) in rank order: an all-gather of the byte sizes, then one of
    the bytes padded to the largest, on host tensors."""
    raw = torch.from_numpy(np.ascontiguousarray(a).view(np.uint8))
    n_proc = dist.get_world_size()
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(n_proc)]
    dist.all_gather(sizes, torch.tensor([raw.numel()], dtype=torch.int64))
    cap = max(1, *(int(n) for n in sizes))
    buf = torch.zeros(cap, dtype=torch.uint8)
    buf[:raw.numel()] = raw
    out = [torch.empty(cap, dtype=torch.uint8) for _ in range(n_proc)]
    dist.all_gather(out, buf)
    return [o[:int(n)].numpy().view(a.dtype) for o, n in zip(out, sizes)]


def _multiprocess() -> bool:
    """True inside a process group of more than one process."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def _process_shards(n_local: int) -> list[int]:
    """The shard count of every process in rank order (no collective in a
    single process)."""
    if not _multiprocess():
        return [n_local]
    return [int(a[0]) for a in _allgather_ragged(np.array([n_local], np.int64))]


def _gather_prepass(counts, e_hist, p_hist):
    """Every process's pre-pass reads in rank order, i.e. global shard
    order: one gather of one row per shard (count, clean, e_hist, p_hist)."""
    n_dev = e_hist.shape[1]
    rows = np.concatenate([np.asarray(counts, np.int64).reshape(-1, 2), e_hist, p_hist], 1)
    rows = np.concatenate([r.reshape(-1, 2 + 2 * n_dev)
                           for r in _allgather_ragged(rows.ravel())])
    return ([tuple(c) for c in rows[:, :2].tolist()], rows[:, 2:2 + n_dev],
            rows[:, 2 + n_dev:])


def _exchange_across(sent: list, rx: list, hist: np.ndarray, per_proc: list[int], devices,
                     n_cols: int):
    """The blocks that cross processes, of one kind: ``sent`` holds (global
    source shard, blocks) of this process's shards, blocks[i][j] payload
    column i (of ``n_cols``, int64) for owner j, and ``hist`` is the kind's
    gathered histogram, so the split sizes need no exchange. One
    `all_to_all_single` per payload column on host-staged blocks, which a
    process without blocks joins too. Each local owner's list in ``rx`` gains
    its received blocks in global source order: those of lower ranks before
    this process's own, the others after."""
    rank = dist.get_rank()
    bounds = np.cumsum([0, *per_proc])
    lo, hi = int(bounds[rank]), int(bounds[rank + 1])
    ranks = [r for r in range(len(per_proc)) if r != rank]
    srcs = [g for g, _ in sent]
    send_split, recv_split = [0] * len(per_proc), [0] * len(per_proc)
    for r in ranks:
        send_split[r] = int(hist[srcs, bounds[r]:bounds[r + 1]].sum())
        recv_split[r] = int(hist[bounds[r]:bounds[r + 1], lo:hi].sum())
    received = []
    for i in range(n_cols):
        parts = [blocks[i][j].cpu() for r in ranks for _, blocks in sent
                 for j in range(bounds[r], bounds[r + 1])]
        send = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.int64)
        recv = torch.empty(sum(recv_split), dtype=torch.int64)
        dist.all_to_all_single(recv, send, recv_split, send_split)
        received.append(recv)
    before, after = [[] for _ in rx], [[] for _ in rx]
    off = 0
    for r in ranks:
        for g in range(bounds[r], bounds[r + 1]):
            for jl, j in enumerate(range(lo, hi)):
                n = int(hist[g, j])
                (before if r < rank else after)[jl].append(
                    [c[off:off + n].to(devices[jl]) for c in received])
                off += n
    return [b + own + a for b, own, a in zip(before, rx, after)]


def _check_step(checks) -> None:
    """Raise when a device count of the step differs from the pre-pass."""
    for name, d, got, want in checks:
        if not np.array_equal(got.cpu().numpy(), np.asarray(want)):
            raise RuntimeError(
                f'multi-device build: shard {d}: {name} disagree with the count '
                'pre-pass (the pre-pass and the build step diverged)')


def _layout(record_codes: list[np.ndarray], record_offsets, k: int, w: int, devices,
            rec_base0: int = 0, sequence_shard: bool = True):
    """Host side of a build over ``devices``: the shards' stream layouts
    (`_shard_layout`) and, per shard, the concatenated streams (oh, pos,
    rec, asm) of the sequence-sharded records it terminates, or None. A
    record above twice the balanced share is sequence-sharded
    (`scan_record_sharded`: one kernel B1 launch per block) when
    ``sequence_shard``; when such records cannot terminate their shards,
    every record takes the plain layout."""
    n_dev = len(devices)
    lengths = [len(c) for c in record_codes]
    seq_budget = max(1 << 16, -(-2 * int(sum(lengths)) // n_dev))
    over = ({i for i, ln in enumerate(lengths) if ln > seq_budget}
            if n_dev > 1 and sequence_shard else set())
    shard_of = _assign_with_oversized(lengths, over, n_dev) if over else None
    if over and shard_of is None:
        logger.warning('oversized records cannot terminate their shards (too many near '
                       'the tail); scanning them in the shard streams')
        over = set()
    if shard_of is None:
        shard_of = partition_records(lengths, n_dev)
    stream = np.array([i for i in range(len(lengths)) if i not in over], dtype=np.int64)
    shards = _shard_layout([record_codes[i] for i in stream], shard_of[stream], devices,
                           k, w, record_offsets, rec_index=stream + rec_base0)
    # in scan order, each after the stream of the shard it terminates
    extras = [None] * n_dev
    for i in sorted(over):
        d = int(shard_of[i])
        x = scan_record_sharded(record_codes[i], k, w, devices, i + rec_base0,
                                record_offsets, devices[d])
        if x is not None:
            extras[d] = x if extras[d] is None else tuple(
                torch.cat(p) for p in zip(extras[d], x))
    return shards, extras


def build_distributed_arrays(record_codes: list[np.ndarray], record_offsets,
                             is_target, kmerlen: int, windowsize: int, devices,
                             rec_base0: int = 0):
    """Multi-device build from parsed records over ``devices`` (a list of
    torch devices, one per shard, repeats allowed). ``record_codes`` are
    the records from global index ``rec_base0`` on; ``record_offsets``
    covers them. Returns (kmers, nodes, edges, n_scanned): the structured
    arrays, byte-equal to the single-device build, and the number of
    shards that held stream bases (one kernel B2 and one kernel B3 launch
    each).

    In a process group of more than one process every process calls this
    with its own records (consecutive across ranks) and local devices; the
    shards of all processes build together and every process gets the
    whole arrays (``n_scanned`` counts its own shards)."""
    devices = [torch.device(d) for d in devices]
    per_proc = _process_shards(len(devices))
    first = sum(per_proc[:dist.get_rank()]) if len(per_proc) > 1 else 0
    n_dev = sum(per_proc)
    k, w = kmerlen, windowsize
    shards, extras = _layout(record_codes, record_offsets, k, w, devices, rec_base0,
                             sequence_shard=len(per_proc) == 1)

    with timeline.span('distributed.prepass'):
        counts, e_hist, p_hist = _read_prepass(_prepass(shards, k, w, n_dev, extras), n_dev)
        if len(per_proc) > 1:
            counts, e_hist, p_hist = _gather_prepass(counts, e_hist, p_hist)
    with timeline.span('distributed.step'):
        rx_nodes, rx_pairs, sent, checks = _step(shards, k, w, counts, e_hist, p_hist, devices,
                                                 extras, first)
    if sent is not None:
        with timeline.span('distributed.exchange'):
            # the payload columns of `_route_shard`: (oh, pos, rec, asm), (u, v, asm)
            rx_nodes = _exchange_across([(g, nb) for g, nb, _ in sent], rx_nodes, e_hist,
                                        per_proc, devices, 4)
            rx_pairs = _exchange_across([(g, pb) for g, _, pb in sent], rx_pairs, p_hist,
                                        per_proc, devices, 3)
        del sent

    # --- owner merge, concatenated in owner order; the k-mer ranges of a
    # process's first owner start after those of every earlier owner ---
    tmask = np.asarray(is_target, dtype=bool)
    kmers, nodes, edges = [], [], []
    base = int(e_hist[:, :first].sum())
    with timeline.span('distributed.merge'):
        for j, dev in enumerate(devices):
            if e_hist[:, first + j].sum():
                oh, pos, rec, asm = (torch.cat(c) for c in zip(*rx_nodes[j]))
                s_pos, s_rec, node_hash, starts, stops, n_tar, n_neg = _merge_nodes(
                    oh, pos, rec, asm, torch.from_numpy(tmask).to(dev))
                kmers.append(_kmers_host(s_pos, s_rec))
                nodes.append(_nodes_host(node_hash, starts, stops, n_tar, n_neg, base))
                base += s_pos.numel()
            if p_hist[:, first + j].sum():
                u, v, asm = (torch.cat(c) for c in zip(*rx_pairs[j]))
                edges.append(_edges_host(*_reduce_edges(u, v, asm)))
    out = [np.concatenate(parts or [np.zeros(0, dtype)])
           for parts, dtype in ((kmers, KMER_DTYPE), (nodes, NODE_DTYPE), (edges, EDGE_DTYPE))]
    if len(per_proc) > 1:
        with timeline.span('distributed.gather'):
            out = [np.concatenate(_allgather_ragged(a)) for a in out]
    _check_step(checks)
    return (*out, sum(s is not None for s in shards))


def merge_graph_parts(parts):
    """Host merge of per-batch (kmers, nodes, edges) builds into the arrays
    ONE build over all records would produce, byte-exact.

    Valid whenever the batches partition WHOLE assemblies in global record
    order: the once-per-assembly node/edge counts of disjoint assembly sets
    add, adjacency pairs never span records (so never span batches), and
    per-node k-mer segments concatenate in batch order = global scan order.
    Backbone of the multi-device ``low_memory`` mode.
    """
    if len(parts) == 1:
        return parts[0]
    kmers_p = [p[0] for p in parts]
    nodes_p = [p[1] for p in parts]
    edges_p = [p[2] for p in parts]

    # --- nodes: union by hash (each part is hash-sorted and duplicate-free;
    # within one part fancy-index += is safe), counts add across batches ---
    uh = np.unique(np.concatenate([n['hash'] for n in nodes_p]))
    G = len(uh)
    n_tar = np.zeros(G, np.uint32)
    n_neg = np.zeros(G, np.uint32)
    total_sizes = np.zeros(G, np.int64)
    idx_p = []
    for npart in nodes_p:
        idx = np.searchsorted(uh, npart['hash'])
        idx_p.append(idx)
        n_tar[idx] += npart['n_tar']
        n_neg[idx] += npart['n_neg']
        total_sizes[idx] += (npart['stop'] - npart['start']).astype(np.int64)
    g_stop = np.cumsum(total_sizes)
    g_start = g_stop - total_sizes
    nodes = np.zeros(G, dtype=NODE_DTYPE)
    nodes['hash'] = uh
    nodes['start'] = g_start
    nodes['stop'] = g_stop
    nodes['n_tar'] = n_tar
    nodes['n_neg'] = n_neg

    # --- kmers: each part's array is exactly its segments tiled in node
    # order; scatter every segment to its node's slot, after the lengths
    # earlier batches already placed there (batch order = scan order) ---
    kmers = np.empty(int(g_stop[-1]) if G else 0, dtype=KMER_DTYPE)
    filled = np.zeros(G, np.int64)
    for kp, npart, idx in zip(kmers_p, nodes_p, idx_p):
        if not len(kp):
            continue
        sizes = (npart['stop'] - npart['start']).astype(np.int64)
        csz = np.cumsum(sizes)
        out_start = g_start[idx] + filled[idx]
        dst = np.repeat(out_start - (csz - sizes), sizes) + np.arange(len(kp))
        kmers[dst] = kp
        filled[idx] += sizes

    # --- edges: union by (first, second), weights (distinct-assembly
    # counts of disjoint assembly sets) add; output stays (first, second)
    # ascending like every build path ---
    alle = np.concatenate(edges_p)
    order = np.lexsort((alle['second'], alle['first']))
    se = alle[order]
    if len(se):
        new = np.ones(len(se), dtype=bool)
        new[1:] = (se['first'][1:] != se['first'][:-1]) | (
            se['second'][1:] != se['second'][:-1])
        starts = np.flatnonzero(new)
        edges = se[starts].copy()
        wsum = np.cumsum(se['weight'].astype(np.int64))
        stops = np.append(starts[1:], len(se))
        prev = np.where(starts > 0, wsum[starts - 1], 0)
        edges['weight'] = wsum[stops - 1] - prev
    else:
        edges = np.zeros(0, dtype=EDGE_DTYPE)
    return kmers, nodes, edges


def build_distributed(assembly_paths, kmerlen: int, windowsize: int, is_targets,
                      devices, n_cpu: int = 1, defer: bool = False, low_memory: bool = False,
                      keep_codes: bool = False):
    """Multi-device graph build over ``devices`` (torch devices, one per
    shard, repeats allowed). Same output contract and bytes as
    `graph.build`: (kmers, nodes, edges, record_offsets, record_ids), or
    with ``defer`` (graph, record_offsets, record_ids) where ``graph`` is an
    `engine.aggregate.HostGraph` whose ``n_chunks`` counts the shard streams
    that held bases, over all batches.

    ``keep_codes`` (with ``defer``) keeps the parsed record codes per
    assembly on ``graph.record_codes``.

    ``low_memory`` bounds the staged streams: assemblies are built in
    consecutive whole-assembly batches, each closed once it reaches
    ``len(devices) * LOW_MEMORY_CHUNK_BASES`` bases, and the per-batch
    results merge on the host byte-exactly (`merge_graph_parts`).
    """
    from ..graph.build import LOW_MEMORY_CHUNK_BASES  # read at call time

    paths = [str(p) for p in assembly_paths]
    targets = [bool(t) for t in is_targets]
    budget = len(devices) * LOW_MEMORY_CHUNK_BASES if low_memory else None
    record_ids: list[tuple[str, ...]] = []
    record_offsets = [0]
    kept_codes: list[list[np.ndarray]] = []
    parts = []
    batch_codes: list[np.ndarray] = []
    batch_bases = 0
    rec_base = 0

    def flush_batch():
        nonlocal batch_codes, batch_bases, rec_base
        if not batch_codes:
            return
        # record_offsets so far covers every record of the batch
        parts.append(build_distributed_arrays(
            batch_codes, np.array(record_offsets, dtype=np.uintp), targets,
            kmerlen, windowsize, devices, rec_base0=rec_base))
        rec_base += len(batch_codes)
        batch_codes, batch_bases = [], 0

    for ids, codes_list in iter_assemblies(paths, n_cpu):
        record_ids.append(tuple(ids))
        record_offsets.append(record_offsets[-1] + len(ids))
        if keep_codes:
            kept_codes.append(codes_list)
        batch_codes.extend(codes_list)
        batch_bases += sum(len(c) for c in codes_list)
        if budget is not None and batch_bases >= budget:
            flush_batch()
    flush_batch()
    offsets = np.array(record_offsets, dtype=np.uintp)
    if parts:
        kmers, nodes, edges = merge_graph_parts([p[:3] for p in parts])
    else:
        kmers = np.zeros(0, KMER_DTYPE)
        nodes = np.zeros(0, NODE_DTYPE)
        edges = np.zeros(0, EDGE_DTYPE)
    if defer:
        graph = HostGraph(kmers, nodes, edges, n_chunks=sum(p[3] for p in parts))
        if keep_codes:
            graph.record_codes = kept_codes
        return graph, offsets, record_ids
    return kmers, nodes, edges, offsets, record_ids
