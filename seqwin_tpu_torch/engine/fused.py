"""One-program graph build: every chunk's scan and the global merge over
one stream of the whole dataset.

Counterpart: `seqwin_tpu/engine/fused.py` (`FusedSpec`, `ChunkPrep`,
`prep_chunk`, `_stack_preps`, `build_fused`, `_prep_one`), reached from
`graph/build.py` with ``SEQWIN_TPU_TORCH_FUSED=1`` (off by default; it
claims no speed).

The chunks of the per-chunk build (the same packing) are prepped in a
thread pool, each writing its augmented byte stream (bit 6 = record start)
into its slice of one page-locked buffer. Every chunk starts at a record
start, so the buffer is the stream of one chunk that holds every record:
a chunk's record starts and patches are rebased by its offset in the
stream, and the local record -> assembly table and the record ids run over
all records (rec_base 0). On the device:

    one h2d -> B1 (`phase1.phase1_z`) per launch group -> the patches ->
    one emission per group -> the emitted streams -> `aggregate_device`
    (`aggregate._merge_nodes`, `_merge_edges`)

A launch group is a run of whole chunks below 2^31 positions: z holds
int32 stream positions, so a longer stream takes several launches. A group
starts at a record start, so its z and its emission do not depend on what
lies before it, and every later group's positions are larger.

Exactness: the chunk body is `hybrid.scan_chunk_device`'s (the patches and
windows of a chunk never reach past its records), and the merge is
`aggregate_device`'s; outputs are byte-identical to the per-chunk build.
The JAX build fills a fixed emission capacity per chunk and returns None
when a chunk overflows it, so its caller falls back to the per-chunk path;
here the emission is exact (its size is the one count the host waits for),
so that fallback has no cause left and `build_fused` always returns. The
caller's one fallback remains: a record above the chunk budget.
"""
from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from . import timeline
from .aggregate import aggregate_device
from .hybrid import _asm_table, _emission, _emitted_streams, chunk_host_prep
from .phase1 import phase1_z

# positions per B1 launch: z holds int32 stream positions
_GROUP_LIMIT = (1 << 31) - 1


@dataclass(frozen=True)
class FusedSpec:
    """Static geometry of one fused build."""

    k: int
    w: int
    n: int                                # stream length, every chunk end to end
    groups: tuple[tuple[int, int], ...]   # [start, stop) of each B1 launch


@dataclass
class ChunkPrep:
    """Host arrays of one chunk, in chunk coordinates."""

    offset: int              # chunk start in the stream
    starts: np.ndarray       # per-record start offsets
    patch_pos: np.ndarray    # irregular window ends
    patch_z: np.ndarray      # their argmin positions, -1 = none


def prep_chunk(record_codes, k: int, w: int, rec_base: int, offset: int,
               out: np.ndarray, parent=None) -> ChunkPrep:
    """Host prep of one chunk into ``out``, its slice of the stream buffer
    (`hybrid.chunk_host_prep`; no device calls, so chunks prep in parallel
    threads, each span a child of ``parent``)."""
    _, starts, irr_pos, patch_z, _ = chunk_host_prep(record_codes, k, w, rec_base, out=out,
                                                     parent=parent)
    return ChunkPrep(offset=offset, starts=starts, patch_pos=irr_pos, patch_z=patch_z)


def _stack_preps(preps: list[ChunkPrep], record_offsets):
    """Every chunk's record starts and patches rebased to the stream and
    concatenated in chunk order (each list stays sorted), and the local
    record -> assembly table of all records. Returns int64 (starts,
    patch_pos, patch_z) and int32 asm_tab."""
    starts = np.concatenate([p.starts + p.offset for p in preps])
    patch_pos = np.concatenate([p.patch_pos.astype(np.int64) + p.offset for p in preps])
    patch_z = np.concatenate([np.where(p.patch_z >= 0, p.patch_z.astype(np.int64) + p.offset, -1)
                              for p in preps])
    return starts, patch_pos, patch_z, _asm_table(record_offsets, 0, len(starts), len(starts))


def _launch_groups(chunk_offsets: np.ndarray) -> tuple[tuple[int, int], ...]:
    """[start, stop) of each B1 launch: runs of whole chunks of at most
    ``_GROUP_LIMIT`` positions (a longer chunk alone), empty runs left out.
    ``chunk_offsets``: the chunks' cumulative sizes, from 0."""
    groups, g0 = [], 0
    for lo, hi in zip(chunk_offsets[:-1], chunk_offsets[1:]):
        if hi - g0 > _GROUP_LIMIT and lo > g0:
            groups.append((g0, int(lo)))
            g0 = int(lo)
    if chunk_offsets[-1] > g0:
        groups.append((g0, int(chunk_offsets[-1])))
    return tuple(groups)


def _fused_scan(stream: torch.Tensor, starts, patch_pos, patch_z, asm_tab, spec: FusedSpec,
                dev: torch.device) -> list:
    """The device side: one h2d of the stream, then per launch group B1, its
    patches, its emission and its emitted streams. Returns one
    (e_oh, e_pos, e_rec, count, e_asm) per group, exact length, in scan
    order."""
    codes_d = stream.to(dev, non_blocking=True)
    starts_d, pp_d, pz_d = (torch.from_numpy(a).to(dev) for a in (starts, patch_pos, patch_z))
    asm_d = torch.from_numpy(asm_tab).to(dev)
    out = []
    for g0, g1 in spec.groups:
        z = phase1_z(codes_d[g0:g1], spec.k, spec.w)
        lo, hi = np.searchsorted(patch_pos, [g0, g1])
        if hi > lo:
            pz = pz_d[lo:hi]
            z[pp_d[lo:hi] - g0] = torch.where(pz >= 0, pz - g0, -1).to(torch.int32)
        eidx = _emission(z).long() + g0
        e_oh, e_pos, e_rec, e_asm = _emitted_streams(codes_d, eidx, spec.k, starts_d, 0, asm_d)
        out.append((e_oh, e_pos, e_rec, eidx.numel(), e_asm))
    return out


def build_fused(
    chunk_lists: list[tuple[list[np.ndarray], int]],
    kmerlen: int,
    windowsize: int,
    record_offsets: np.ndarray,
    is_target,
    n_cpu: int = 1,
    defer: bool = False,
    device=None,
):
    """The fused build: prep the chunks (parallel host threads) into one
    page-locked stream, run the device side, aggregate.

    Args:
        chunk_lists: [(record_codes, rec_base), ...] in global scan order
            (`graph.build._group_chunks`), no record above the chunk budget.

    Returns what `aggregate_device` returns for ``defer``: (kmers, nodes,
    edges), or a `DeviceGraph` whose ``n_chunks`` is the number of B1
    launches (launch groups).
    """
    dev = resolve_device(device)
    sizes = [sum(len(c) for c in recs) for recs, _ in chunk_lists]
    chunk_offsets = np.concatenate([[0], np.cumsum(sizes, dtype=np.int64)])
    spec = FusedSpec(k=kmerlen, w=windowsize, n=int(chunk_offsets[-1]),
                     groups=_launch_groups(chunk_offsets))
    stream = torch.empty(spec.n, dtype=torch.uint8, pin_memory=dev.type == 'cuda')
    prep = functools.partial(_prep_one, k=kmerlen, w=windowsize, stream=stream.numpy(),
                             parent=timeline.current())
    items = [(recs, rec_base, int(chunk_offsets[c]), int(chunk_offsets[c + 1]))
             for c, (recs, rec_base) in enumerate(chunk_lists)]
    workers = max(1, min(int(n_cpu), len(items)))
    if workers > 1:
        with ThreadPoolExecutor(max_workers=workers) as ex:
            preps = list(ex.map(prep, items))
    else:
        preps = [prep(it) for it in items]
    is_target = np.asarray(is_target, dtype=bool)
    if not spec.groups:
        return aggregate_device([], is_target, defer=defer)
    starts, patch_pos, patch_z, asm_tab = _stack_preps(preps, record_offsets)
    chunks = _fused_scan(stream, starts, patch_pos, patch_z, asm_tab, spec, dev)
    return aggregate_device(chunks, is_target, defer=defer)


def _prep_one(item, k, w, stream, parent):
    record_codes, rec_base, lo, hi = item
    return prep_chunk(record_codes, k, w, rec_base, lo, stream[lo:hi], parent)
