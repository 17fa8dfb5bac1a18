#!/usr/bin/env python3
"""Smoke test of seqwin_tpu_torch on one CUDA GPU.

Run from the repository root on a machine with an H100 and nvcc:

    python3 chip_smoke.py [--seed 0] [--profile]

Phases, each fatal on failure (non-zero exit, no ``ok`` line):

1. Environment and build: the card's name and power limit, the shard
   devices D of the multi-device build (every card when there are several,
   else four shards on card 0), then the package's CUDA kernels (B1
   `phase1_z`, B2 `phase1_zc`, B3 `phase1_pfx` from ``phase1.cu``;
   `sketch_cut` and `sketch_select` from ``sketch.cu``) built with nvcc
   from ``seqwin_tpu_torch/csrc``.
2. Each kernel against its plain torch version on the card, on seeded
   streams with N runs, short and empty records and small-k tie cases over a
   (k, w) grid, on tile-edge streams over the same grid and one w above the
   kernel's tile (homopolymers, period-2..7 repeats, record starts and N
   runs around tile and segment edges; at every byte alignment), one
   2^25-position chunk at k=21, w=200 (the single-device path's chunk), and
   for B2 and B3 the first shard stream of the main path over D (the
   multi-device path's input). Exact equality of every output is
   required; both versions are timed with CUDA events on the main-path
   input of each kernel and on the 2^25 chunk, the kernel also with the L2
   cache flushed before each launch.
3. On a reduced synthetic dataset (8 assemblies x ~1 Mbp): the GPU build
   against the package's CPU build, then the multi-device build over D
   against the GPU build, all five outputs byte-equal, with B2 and B3
   launched once per shard holding bases and B1 not at all. Then the
   multi-device pre-pass and build step, and the single-device build's
   deferred dispatch of every chunk (at a 2^21-base budget, up to the
   batched count fetch), run again under torch's sync debug mode 'error':
   any call in them that waits on the device fails the phase.
4. The main path at a real size: 64 genomes x 3 Mbp (192 Mbp), k=21,
   w=200, through `build_deferred` (the deferred, threaded chunk dispatch)
   and through `build_distributed` over D, each followed by the host
   penalty threshold the pipeline uses without mash, `filter_edges` and
   `compact_kmers`; output invariants and per-kernel launch counts are
   checked for each run, and the two runs' nodes and edges must be equal.
   One more single-device build runs with ``SEQWIN_TPU_TORCH_TIMELINE=1``
   and prints its prep, dispatch and fetch gaps. ``--profile`` traces one
   more run of each with torch.profiler and prints the device-time table
   and the package's host spans.
5. The whole pipeline on the card. Reduced: `python -m seqwin_tpu_torch
   --no-mash --no-blast -p 8` in a subprocess on the golden171 proxy cut to
   24 genomes x 1 Mbp (10 targets), its signatures.fasta, signatures.csv
   and assemblies.csv, and the arrays of a --no-filter run's graph.npz,
   byte-equal to the port's CPU run (`run(Config(..., device='cpu'))`).
   Full scale: the proxy at 72 + 99 genomes x 4.7 Mbp (~804 Mbp),
   `cli.main` in this process twice with -p 8 (forked marker workers under
   a live CUDA context); at least one signature, kernel B1 launched once
   per 2^25-base chunk and B2/B3 never, both runs byte-equal; wall time,
   the per-phase `Finished in` seconds and the peak device memory of each
   run, and the timeline gaps of the second (``SEQWIN_TPU_TORCH_TIMELINE=1``).
   ``--profile`` traces the second run through `Config.profile_dir` and
   prints its device busy.
6. Long records, low memory, the host backend and the sort engine on the
   card. (1) The golden171 proxy with each genome as ONE record (72 + 99
   complete genomes x 4.7 Mbp, ~804 Mbp, every record above the 2^22-base
   low-memory budget): `cli.main --low-memory` and the normal `cli.main`,
   -p 8, their signatures.fasta, signatures.csv and assemblies.csv
   byte-equal; under --low-memory B1 launched once per block of the
   records' block plans and B2/B3 never; wall time and `Finished in`
   seconds of both. (2) One ~100 Mbp record and three short ones: the
   default 2^25 budget (the record in halo'd blocks), one 2^27 chunk, and
   `build_distributed` over D (the record sequence-sharded) all byte-equal,
   each with the launches of its plan; then phase 3's no-sync check of the
   pre-pass and step with the sequence-sharded stream in them. (3) The
   phase-4 192 Mbp data through `build_distributed(low_memory=True)` over
   D (batches of whole assemblies merged on the host) byte-equal to the
   single-device build.
   (4) `python -m seqwin_tpu_torch --backend numpy` with no card visible on
   phase 5's reduced proxy, its three files byte-equal to the GPU CLI run;
   ``SEQWIN_TPU_TORCH_SCAN=sort`` on phase 3's data byte-equal to the
   hybrid build, launching no kernel.
7. Device MinHash sketches (``--sketch-mode device``). (1) `cli.main
   --sketch-mode device` on the card on phase 5's reduced proxy, plain and
   with ``--seed-pattern``, each against the port's CPU run with the same
   options: signatures.fasta, signatures.csv and assemblies.csv byte-equal;
   the plain run launches `sketch_cut` once per chunk of the cut path's
   plan and `sketch_select` once, the seed-pattern run neither.
   (2) The same option on the 804 Mbp proxy (phase 5's data): wall time,
   `Finished in` seconds, the threshold it computed against the minimizer
   estimate of phase 5's run, B1 once per chunk, `sketch_cut` once per
   chunk of the plan and `sketch_select` once; then the sketches of all
   171 assemblies and their Jaccard matrix timed alone, with the same
   launches and no assembly redone on the torch path, and the card's
   sketches of three assemblies and the whole matrix equal to the CPU's
   (``--profile``: the sketches traced once more); then `sketch_cut` on
   each of the plan's chunks and `sketch_select` on its candidates against
   their plain versions on the card (equal counters, kept-value sets and
   rows), each timed with CUDA events against its bound. (3)
   `build_distributed(..., keep_codes=True)` over D on the reduced proxy,
   its kept codes equal to the parse.
8. The multi-host build: two OS processes on the card, ranks of one gloo
   group through ``SEQWIN_TPU_MULTIHOST=127.0.0.1:<port>,2,<rank>``
   (``chip_smoke.py --worker``). (1) Phase 4's 192 Mbp data through
   `graph.build_deferred`, plain (cold, then warm) and with ``low_memory``:
   both processes' arrays byte-equal to the single-device build (a SHA-256
   of the arrays), B2 and B3 once per batch in which a process holds
   bases. (2) The reduced CLI (phase 5) in both processes, each with its
   own --prefix, plain and with ``--sketch-mode device``: its files
   byte-equal to the single-process runs, the sketch run's `sketch_cut`
   and `sketch_select` launches those of phase 7's. Seconds and launches per
   process; ``--profile`` traces one more build in each (device busy, host
   spans).

It prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. It imports
nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import logging
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
K, W = 21, 200
GRID = [(1, 4), (4, 3), (7, 10), (21, 200), (31, 16), (2, 9), (3, 17)]
MAIN_GENOMES, MAIN_LEN = 64, 3_000_000
PROXY = (72, 99, 4_700_000)    # golden171 proxy: targets, non-targets, genome length
LONG_LEN = 100_000_000         # phase 6's long record
EDGE_W = 4500                  # a window longer than the kernel's tile
SEED_PATTERN = '110110110111011011011'  # a spaced seed as long as k (15 care positions)
SKETCHES_HELD = (0, 72, 170)   # proxy assemblies whose card sketches are held to the CPU's
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
INT32_PER_SM_CLOCK = 64        # Hopper's 32-bit integer instruction rate per SM
SMS = 132                      # H100 SXM
# 32-bit instructions per position of the least phase-1 algorithm (rolling
# fwd/rev hash, canonical add, validity, prefix/suffix argmin and combine,
# clean, z); the count is derived in the header of csrc/phase1.cu
OPS_PER_POS = {'phase1_z': 50, 'phase1_zc': 50, 'phase1_pfx': 54}
PHASE1_KERNELS = ('phase1_z', 'phase1_zc', 'phase1_pfx')
SKETCH_KERNELS = ('sketch_cut', 'sketch_select')
SKETCH_SIZE = 1000                # the sketch size of phase 7's runs (the CLI's default)


def log(*a):
    print(*a, flush=True)


def smi() -> str:
    res = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout.strip() else 'nvidia-smi unavailable'


def sm_clock_hz() -> tuple[float, str]:
    """The card's maximum SM clock (`nvidia-smi --query-gpu=clocks.max.sm`)
    and where it came from."""
    res = subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.max.sm', '--format=csv,noheader,nounits'],
        capture_output=True, text=True, timeout=60)
    try:
        return float(res.stdout.strip().splitlines()[0]) * 1e6, 'nvidia-smi clocks.max.sm'
    except (ValueError, IndexError):
        return 1.98e9, 'assumed 1980 MHz (nvidia-smi clocks.max.sm unreadable)'


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def cold_ms(fn, iters: int) -> float:
    """Mean ms of one launch of ``fn`` with the L2 cache flushed (a 256 MB
    write) before each, CUDA events around the launch alone."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device='cuda')
    fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def aug_stream(records: list[np.ndarray]) -> np.ndarray:
    """Concatenated records with bit 6 at each record start."""
    codes = np.concatenate(records) if records else np.zeros(0, np.uint8)
    starts = np.cumsum([0] + [len(r) for r in records[:-1]])
    codes[starts[starts < len(codes)]] |= 64
    return codes


def mixed_records(rng, scale: int = 1) -> list[np.ndarray]:
    """Records with N runs, scattered Ns, short, empty and heavy-N records."""
    recs = []
    for n_rec, frac in [(900, 0.0), (2500, 0.02), (0, 0.0), (40, 0.0), (1300, 0.1),
                        (3, 0.0), (5000, 0.0), (2000, 0.4)]:
        n_rec *= scale
        c = rng.integers(0, 4, size=n_rec).astype(np.uint8)
        c[rng.random(n_rec) < frac] = 255
        if n_rec > 1000:
            s = int(rng.integers(0, n_rec - 100))
            c[s:s + int(rng.integers(1, 100))] = 255
        recs.append(c)
    return recs


def chunk_stream(seed: int) -> np.ndarray:
    """One main-path chunk: 2^25 positions, 3 Mbp records with four N runs
    each."""
    rng = np.random.default_rng(seed)
    n = 1 << 25
    lens = [MAIN_LEN] * (n // MAIN_LEN)
    recs = [rng.integers(0, 4, size=L).astype(np.uint8) for L in lens]
    recs.append(rng.integers(0, 4, size=n - sum(lens)).astype(np.uint8))
    for r in recs:
        for s in rng.integers(0, len(r) - 200, size=4):
            r[s:s + int(rng.integers(1, 200))] = 255
    return aug_stream(recs)


def edge_stream(rng, n_tiles: int, tile: int, k: int, w: int) -> np.ndarray:
    """Augmented stream of n_tiles * tile + tile // 2 positions where ties
    and boundaries are everywhere: random bases cut by homopolymer runs and
    period-2..7 repeats, and at tile edges a record start, an N run and a
    4-coded base at an offset that changes from edge to edge, around the
    edge and around one of the segment edges (segments of w from the tile's
    halo start); edges at least 2 (w + k) apart, so clean windows remain."""
    n = n_tiles * tile + tile // 2
    c = rng.integers(0, 4, size=n).astype(np.uint8)
    pos = 0
    while pos < n:
        ln = int(rng.integers(w // 2 + 1, 3 * w + 2 * k + 8))
        kind = int(rng.integers(0, 8))  # 0 random, 1 homopolymer, p >= 2 period p
        if kind == 1:
            c[pos:pos + ln] = rng.integers(0, 4)
        elif kind >= 2:
            c[pos:pos + ln] = np.resize(rng.integers(0, 4, size=kind), len(c[pos:pos + ln]))
        pos += ln
    near = sorted(set(range(-k - 2, k + 3)) | {-w - 1, -w, -w + 1, w - 2, w - 1, w, w + 1})
    n_seg = -(-(tile + w - 1) // w)
    starts = [0]
    for m in range(1, n_tiles + 1, -(-2 * (w + k) // tile)):
        edge = m * tile
        seg = edge - (w - 1) + w * (m % n_seg)
        starts.append(edge + near[m % len(near)])
        a = edge + near[(3 * m + 1) % len(near)]
        c[max(a, 0):max(a + 1 + m % (k + 2), 0)] = 255
        b = seg + near[(5 * m + 2) % len(near)]
        c[max(b, 0):max(b + 1 + m % 3, 0)] = 255
        d = seg + near[(7 * m + 3) % len(near)]
        if 0 <= d < n:
            c[d] = 4
    s = np.array(starts)
    c[s[(s >= 0) & (s < n)]] |= 64
    return c


def phase_build():
    from seqwin_tpu_torch import mash
    from seqwin_tpu_torch.engine import _kernels, phase1

    for src, lib, names in (('phase1', phase1._lib, 'B1, B2, B3'),
                            ('sketch', mash._lib, 'sketch_cut, sketch_select')):
        t0 = time.perf_counter()
        lib()
        log(f'[build] {src} (kernels {names}) built and loaded in '
            f'{time.perf_counter() - t0:.2f} s')
        txt = _kernels.BUILD_DIR / f'{src}.ptxas.txt'
        if txt.exists():
            log(f'[build] ptxas {src}: ' + ' | '.join(
                ln.strip() for ln in txt.read_text().splitlines() if 'Used' in ln or 'spill' in ln))


def _kernel_specs():
    """Per kernel: name, TPU kernel mode it replaces, its wrapper and plain
    version as functions of (codes, k, w) returning a tuple of tensors, and
    the bytes it must move and the 32-bit integer instructions it must
    execute per position."""
    from seqwin_tpu_torch.engine import phase1

    def pfx_plain(codes, k, w):
        return phase1.pfx_from_z(phase1.phase1_z_plain(codes, k, w), phase1._TILE)

    return [
        ('phase1_z', 'seqwin_tpu/engine/pallas_scan.py:202',
         lambda c, k, w: (phase1.phase1_z(c, k, w),),
         lambda c, k, w: (phase1.phase1_z_plain(c, k, w),), 1 + 4, OPS_PER_POS['phase1_z']),
        ('phase1_zc', 'seqwin_tpu/engine/pallas_scan.py:350',
         phase1.phase1_zc, phase1.phase1_zc_plain, 1 + 4 + 8, OPS_PER_POS['phase1_zc']),
        ('phase1_pfx', 'seqwin_tpu/engine/pallas_scan.py:318',
         lambda c, k, w: phase1.phase1_pfx(c, k, w)[:2], pfx_plain, 1 + 4 + 4,
         OPS_PER_POS['phase1_pfx']),
    ]


def _compare(got, want):
    """(mismatches, max |difference|) over every output tensor."""
    bad = sum(int((a != b).sum()) for a, b in zip(got, want))
    worst = max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
                for a, b in zip(got, want))
    return bad, worst


def parse_records(paths):
    """Records and cumulative record counts of the assemblies at ``paths``."""
    from seqwin_tpu_torch.io.fasta import iter_assemblies

    records, offsets = [], [0]
    for ids, codes in iter_assemblies([str(p) for p in paths], 8):
        records += codes
        offsets.append(offsets[-1] + len(ids))
    return records, np.array(offsets, dtype=np.uintp)


def first_shard_stream(paths, devices):
    """The first shard's augmented stream of the multi-device build over
    ``devices`` (`_shard_layout` of the parsed records), on its card: the
    input kernels B2 and B3 get on that path."""
    from seqwin_tpu_torch.parallel import distributed as dist

    records, offsets = parse_records(paths)
    shard_of = dist.partition_records([len(c) for c in records], len(devices))
    return dist._shard_layout(records, shard_of, devices[:1], K, W, offsets)[0]['codes']


def time_kernel(fn, plain, codes, bytes_per_pos: int, ops_per_pos: int,
                int_ops_per_s: float) -> dict:
    """Kernel ms (CUDA events, L2 warm over 20 launches and flushed before
    each of 5) and plain ms on ``codes`` at k=21, w=200, and the bound:
    each input byte read once and each output written once at the memory
    rate, or the least algorithm's 32-bit integer instructions at the
    card's integer rate, whichever takes longer."""
    n = codes.numel()
    ms = cuda_ms(lambda: fn(codes, K, W), iters=20)
    cold = cold_ms(lambda: fn(codes, K, W), iters=5)
    plain_ms = cuda_ms(lambda: plain(codes, K, W), iters=3, warmup=1)
    bytes_s = bytes_per_pos * n / HBM_BYTES_PER_S
    ops_s = ops_per_pos * n / int_ops_per_s
    return dict(n=n, ms=ms, ms_l2_flushed=cold, plain_ms=plain_ms,
                bound_ms=max(bytes_s, ops_s) * 1e3,
                bound_by='bytes' if bytes_s >= ops_s else 'operations',
                bytes_ms=bytes_s * 1e3, ops_ms=ops_s * 1e3)


def phase_kernels(seed: int, shard_codes) -> list[dict]:
    """Each kernel against its plain version on the GRID and tile-edge
    streams, on one 2^25 chunk and (B2, B3) on ``shard_codes``, the first
    shard stream of the multi-device main path; exact equality, both timed
    with CUDA events on the kernel's main-path input and on the chunk."""
    import torch

    from seqwin_tpu_torch.engine import phase1

    dev = torch.device('cuda')
    streams = []
    for k, w in GRID:
        rng = np.random.default_rng(seed + 7 * k + w)
        streams.append((k, w, torch.from_numpy(aug_stream(mixed_records(rng, scale=4))).to(dev)))
    # tile-edge streams at the kernel's tile, over the grid and a w above
    # it, as views at byte offsets 0..3 so the kernel's word-wide staging
    # meets every alignment
    for j, (k, w) in enumerate(GRID + [(K, EDGE_W)]):
        a = torch.from_numpy(edge_stream(np.random.default_rng(seed + 11 * k + w), 64,
                                         phase1._TILE, k, w))
        buf = torch.empty(a.numel() + 3, dtype=torch.uint8, device=dev)
        streams.append((k, w, buf[j % 4:j % 4 + a.numel()].copy_(a)))
    hz, hz_from = sm_clock_hz()
    int_ops_per_s = INT32_PER_SM_CLOCK * SMS * hz
    log(f'[kernel] bound rates: memory {HBM_BYTES_PER_S / 1e12:.2f} TB/s; 32-bit integer '
        f'{INT32_PER_SM_CLOCK} per SM per clock x {SMS} SMs x {hz / 1e6:.0f} MHz ({hz_from}) '
        f'= {int_ops_per_s / 1e12:.2f} T/s')
    chunk = torch.from_numpy(chunk_stream(seed)).to(dev)
    n = chunk.numel()

    out = []
    for name, replaces, fn, plain, bytes_per_pos, ops_per_pos in _kernel_specs():
        # B1 runs on the single-device path's chunks, B2 and B3 on the
        # multi-device path's shard streams
        main_in = chunk if name == 'phase1_z' else shard_codes
        inputs = streams + [(K, W, chunk)] + ([] if main_in is chunk else [(K, W, main_in)])
        worst = 0
        for k, w, codes in inputs:
            got, want = fn(codes, k, w), plain(codes, k, w)
            torch.cuda.synchronize()
            bad, err = _compare(got, want)
            del got, want
            worst = max(worst, err)
            log(f'[kernel] {name} k={k} w={w} n={codes.numel()} mismatches={bad}')
            if bad:
                raise AssertionError(f'{name} k={k} w={w}: {bad} mismatches')
        rates = (bytes_per_pos, ops_per_pos, int_ops_per_s)
        at_chunk = time_kernel(fn, plain, chunk, *rates)
        at_main = at_chunk if main_in is chunk else time_kernel(fn, plain, main_in, *rates)
        for label, t in (('2^25 chunk', at_chunk), ('main-path input', at_main)):
            log(f"[kernel] {name} {label} n={t['n']} k={K} w={W}: mismatches=0 kernel "
                f"{t['ms']:.4f} ms ({t['ms_l2_flushed']:.4f} ms L2 flushed), plain "
                f"{t['plain_ms']:.3f} ms, bound {t['bound_ms'] * 1e3:.1f} us set by "
                f"{t['bound_by']} (bytes {t['bytes_ms'] * 1e3:.1f} us, operations "
                f"{t['ops_ms'] * 1e3:.1f} us at {ops_per_pos} per position)")
        out.append(dict(name=name, route='cuda', source='seqwin_tpu_torch/csrc/phase1.cu',
                        replaces=replaces, launches=None, mismatches=0,
                        max_abs_err=float(worst), **at_main, library_ms=None,
                        chunk_n=n, chunk_ms=at_chunk['ms'],
                        chunk_ms_l2_flushed=at_chunk['ms_l2_flushed'],
                        chunk_plain_ms=at_chunk['plain_ms'], chunk_bound_ms=at_chunk['bound_ms'],
                        chunk_bound_by=at_chunk['bound_by']))
    return out


def launch_counters():
    """The launch counter of each of the package's kernels, by name."""
    from seqwin_tpu_torch import mash
    from seqwin_tpu_torch.engine import phase1

    return {**{name: getattr(phase1, name) for name in PHASE1_KERNELS},
            **{name: getattr(mash, name) for name in SKETCH_KERNELS}}


def want_launches(b1: int, b2: int, b3: int, cut: int = 0, select: int = 0) -> dict:
    """The `read_launches` of a run that launches B1, B2, B3, `sketch_cut`
    and `sketch_select` so many times."""
    return dict(zip(PHASE1_KERNELS + SKETCH_KERNELS, (b1, b2, b3, cut, select)))


def expected_cuts(records_by_assembly) -> int:
    """`sketch_cut` launches of the cut path's sketches of these
    assemblies: one a chunk of `mash.chunk_plan` that holds a position."""
    from seqwin_tpu_torch import mash

    lengths = [mash.stream_bases(r) for r in records_by_assembly]
    return sum(any(lengths[a0:a1]) for a0, a1 in mash.chunk_plan(lengths, mash.CHUNK_BASES))


def read_launches() -> dict:
    return {name: fn.launches for name, fn in launch_counters().items()}


def reset_launches():
    for fn in launch_counters().values():
        fn.launches = 0


def shard_devices() -> list:
    """Every card when there are several, else four shards on card 0."""
    import torch

    n = torch.cuda.device_count()
    if n >= 2:
        return [torch.device('cuda', i) for i in range(n)]
    return [torch.device('cuda', 0)] * 4


def write_fasta(path: Path, records: list[tuple[str, np.ndarray]]):
    """80-column FASTA; code 4 is written as N."""
    alphabet = np.frombuffer(b'ACGTN', dtype=np.uint8)
    with open(path, 'wb') as f:
        for rid, g in records:
            f.write(f'>{rid}\n'.encode())
            seq = alphabet[np.minimum(g, 4)]
            full = len(seq) // 80
            body = np.full((full, 81), ord('\n'), np.uint8)
            body[:, :80] = seq[:full * 80].reshape(full, 80)
            f.write(body.tobytes())
            if len(seq) > full * 80:
                f.write(seq[full * 80:].tobytes() + b'\n')


def synth(tmp: Path, n_genomes: int, genome_len: int, rng, n_records: int = 1,
          n_runs: int = 0, empty_record: bool = False):
    """Shared base genome, ~0.5% SNPs per genome, the first half targets."""
    base = rng.integers(0, 4, size=genome_len).astype(np.uint8)
    paths, targets = [], []
    for i in range(n_genomes):
        g = base.copy()
        idx = rng.integers(0, genome_len, size=genome_len // 200)
        g[idx] = (g[idx] + rng.integers(1, 4, size=idx.size)) % 4
        for s in rng.integers(0, genome_len - 500, size=n_runs):
            g[s:s + int(rng.integers(1, 500))] = 4
        cuts = np.sort(rng.integers(0, genome_len, size=n_records - 1))
        recs = [(f'g{i}_r{j}', part) for j, part in enumerate(np.split(g, cuts))]
        if empty_record and i == 1:
            recs.insert(1, (f'g{i}_empty', np.zeros(0, np.uint8)))
        p = tmp / f'g{i}.fasta'
        write_fasta(p, recs)
        paths.append(p)
        targets.append(i < n_genomes // 2)
    return paths, targets


def _assert_same_build(name, got, want):
    for part, a, b in zip(('kmers', 'nodes', 'edges', 'record_offsets'), got[:4], want[:4]):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f'{name}: {part} differ')
    if got[4] != want[4]:
        raise AssertionError(f'{name}: record_ids differ')


def check_no_sync(paths, devices):
    """The multi-device pre-pass and build step over ``devices`` enqueue
    without a host sync: each runs under torch's sync debug mode 'error',
    which raises on any call that waits on the device. The layout before
    them (host prep, and the scan of sequence-sharded records) may sync."""
    import torch

    from seqwin_tpu_torch.parallel import distributed as dist

    records, offsets = parse_records(paths)
    n_dev = len(devices)
    shards, extras = dist._layout(records, offsets, K, W, devices)
    torch.cuda.synchronize()

    def strict(fn, *args):
        torch.cuda.set_sync_debug_mode('error')
        try:
            return fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode('default')

    # the guard is live: a call that reads the device's data back raises
    try:
        strict(torch.bincount, torch.zeros(1, dtype=torch.int64, device=devices[0]))
    except RuntimeError:
        pass
    else:
        raise AssertionError("sync debug mode 'error' let torch.bincount through")
    pre = strict(dist._prepass, shards, K, W, n_dev, extras)
    counts, e_hist, p_hist = dist._read_prepass(pre, n_dev)
    _, _, _, checks = strict(dist._step, shards, K, W, counts, e_hist, p_hist, devices, extras)
    dist._check_step(checks)
    n_x = sum(x is not None for x in extras)
    log(f'[no-sync] pre-pass and build step of {sum(s is not None for s in shards)} shard '
        f'streams{f" and {n_x} sequence-sharded streams" if n_x else ""} ran under sync debug '
        "mode 'error' without a sync; step counts agree with the pre-pass")


def check_no_sync_deferred(paths, budget: int = 1 << 21):
    """The single-device build's deferred dispatch (`hybrid.scan_chunk_deferred`)
    of every chunk of ``paths`` at ``budget`` enqueues without a host sync,
    up to the batched count fetch: the dispatches run under sync debug mode
    'error' after the host prep (`hybrid.pinned_host_prep`); the fetched
    counts and trimmed streams equal the synchronous `scan_chunk_device`."""
    import torch

    from seqwin_tpu_torch.engine import hybrid

    dev = torch.device('cuda')
    records, offsets = parse_records(paths)
    chunks = [(records[lo:hi], lo) for lo, hi in pack_chunks([len(r) for r in records], budget)]
    preps = [hybrid.pinned_host_prep(recs, K, W, base, offsets, dev) for recs, base in chunks]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        res = [hybrid.scan_chunk_deferred(p, K, W, base, dev)
               for p, (_, base) in zip(preps, chunks)]
    finally:
        torch.cuda.set_sync_debug_mode('default')
    counts = torch.stack([r[3] for r in res]).tolist()
    for (recs, base), r, count in zip(chunks, res, counts):
        want = hybrid.scan_chunk_device(recs, K, W, base, offsets, device=dev)
        if count != want[3] or count > r[0].numel() or not all(
                torch.equal(a[:count], b) for a, b in zip(r[:3] + r[4:], want[:3] + want[4:])):
            raise AssertionError(f'deferred dispatch of the chunk at record {base} differs '
                                 'from the synchronous scan')
    log(f'[no-sync] single-device deferred dispatch of {len(chunks)} chunks (budget {budget}) '
        "ran under sync debug mode 'error' without a sync; one batched count fetch; counts "
        'and streams equal the synchronous scan')


def timeline_gaps(events) -> dict:
    """Gaps of one build's timeline (``SEQWIN_TPU_TORCH_TIMELINE=1``), ms:
    per chunk, prep start to its dispatch (the prep, then the wait for the
    main thread), and its dispatch (h2d submit to dispatched: the enqueue
    of the h2d, B1, the patches, the emission and the streams); the main
    thread between two dispatches; the last dispatch to the count fetch;
    the fetch's wait (the card finishing what was queued); the fetch to
    the node merge's end and on to the node columns' d2h; and the wall
    from the first prep to that d2h. Marks are stamped in ns."""
    chunks, rest = {}, {}
    for t, name, attrs in events:
        if 'rec_base' in attrs:
            chunks.setdefault(attrs['rec_base'], {})[name] = t
        else:
            rest[name] = t
    order = sorted((c for c in chunks.values() if 'dispatched' in c),
                   key=lambda c: c['h2d_submit'])

    def ms(vals):
        vals = [v / 1e6 for v in vals]
        return dict(sum=sum(vals), max=max(vals, default=0.0), n=len(vals),
                    max_at=int(np.argmax(vals)) if vals else None)

    first = order[0]['prep_start']
    return dict(
        chunks=len(order),
        prep_to_dispatch_ms=ms(c['h2d_submit'] - c['prep_start'] for c in order),
        dispatch_ms=ms(c['dispatched'] - c['h2d_submit'] for c in order),
        between_dispatches_ms=ms(b['h2d_submit'] - a['dispatched']
                                 for a, b in zip(order, order[1:])),
        first_prep_to_first_dispatch_ms=(order[0]['h2d_submit'] - first) / 1e6,
        first_prep_to_last_dispatch_ms=(order[-1]['dispatched'] - first) / 1e6,
        last_dispatch_to_fetch_ms=(rest['counts_fetch_start'] - order[-1]['dispatched']) / 1e6,
        fetch_wait_ms=(rest['counts_fetched'] - rest['counts_fetch_start']) / 1e6,
        fetch_to_merge_nodes_ms=(rest['agg_merge_nodes_done'] - rest['counts_fetched']) / 1e6,
        merge_nodes_to_nodes_d2h_ms=(rest['agg_kn_d2h_done'] - rest['agg_merge_nodes_done']) / 1e6,
        first_prep_to_nodes_d2h_ms=(rest['agg_kn_d2h_done'] - first) / 1e6)


def timeline_run(fn):
    """``fn()`` with ``SEQWIN_TPU_TORCH_TIMELINE=1`` (a build reads it when
    it starts): (its result, `timeline_gaps` of its events)."""
    from seqwin_tpu_torch.engine import timeline

    os.environ['SEQWIN_TPU_TORCH_TIMELINE'] = '1'
    timeline.reset()
    try:
        out = fn()
        events = timeline.drain()
    finally:
        del os.environ['SEQWIN_TPU_TORCH_TIMELINE']
        timeline.reset()
    return out, timeline_gaps(events)


def phase_small(seed: int, devices):
    """8 x 1 Mbp (3 records each, N runs, one empty record): the GPU build
    against the CPU build, and the multi-device build over ``devices``
    against the single-device GPU build, all five outputs byte-equal; then
    `check_no_sync` on the same data."""
    from seqwin_tpu_torch.graph import build
    from seqwin_tpu_torch.parallel import build_distributed

    rng = np.random.default_rng(seed + 1)
    with tempfile.TemporaryDirectory() as td:
        paths, targets = synth(Path(td), 8, 1_000_000, rng, n_records=3, n_runs=3,
                               empty_record=True)
        t0 = time.perf_counter()
        gpu = build(paths, K, W, targets, n_cpu=8, device='cuda')
        t_gpu = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = build(paths, K, W, targets, n_cpu=8, device='cpu')
        t_cpu = time.perf_counter() - t0
        sort, sort_launches, t_sort = sort_engine_build(paths, targets)
        before = read_launches()
        t0 = time.perf_counter()
        graph, offsets, ids = build_distributed(paths, K, W, targets, devices, n_cpu=8, defer=True)
        t_multi = time.perf_counter() - t0
        grew = {k: v - before[k] for k, v in read_launches().items()}
        check_no_sync(paths, devices)
        check_no_sync_deferred(paths)
    _assert_same_build('GPU build vs CPU build', gpu, cpu)
    log(f'[cpu-vs-gpu] 8 x 1 Mbp: byte-equal kmers={len(gpu[0])} nodes={len(gpu[1])} '
        f'edges={len(gpu[2])} (gpu {t_gpu:.2f} s, cpu {t_cpu:.2f} s)')
    _assert_same_build('sort engine vs hybrid build', sort, gpu)
    if any(sort_launches.values()):
        raise AssertionError(f'sort engine build launched kernels: {sort_launches}')
    log(f'[phase6 sort] 8 x 1 Mbp: SEQWIN_TPU_TORCH_SCAN=sort on the card byte-equal to the '
        f'hybrid build in {t_sort:.2f} s; launches {sort_launches}')
    kmers, edges = graph.materialize()
    _assert_same_build('multi-device vs single-device build',
                       (kmers, graph.nodes, edges, offsets, ids), gpu)
    want = want_launches(0, graph.n_chunks, graph.n_chunks)
    if grew != want or not graph.n_chunks:
        raise AssertionError(f'multi-device launches {grew}, expected {want}')
    log(f'[multi-vs-single] 8 x 1 Mbp over {len(devices)} shards {[str(d) for d in devices]}: '
        f'byte-equal to the single-device build; launches {grew} '
        f'({graph.n_chunks} shards with bases) in {t_multi:.2f} s')


def sort_engine_build(paths, targets):
    """The single-device GPU build on the sort engine
    (``SEQWIN_TPU_TORCH_SCAN=sort``): (result, kernel launches, seconds)."""
    from seqwin_tpu_torch.graph import build

    before = read_launches()
    os.environ['SEQWIN_TPU_TORCH_SCAN'] = 'sort'
    try:
        t0 = time.perf_counter()
        res = build(paths, K, W, targets, n_cpu=8, device='cuda')
        secs = time.perf_counter() - t0
    finally:
        del os.environ['SEQWIN_TPU_TORCH_SCAN']
    return res, {k: v - before[k] for k, v in read_launches().items()}, secs


def main_path(build_fn, paths, targets, config):
    """A deferred build (``build_fn``) + the pipeline's device consumption
    without mash: the host float64 penalty and threshold of
    `pipeline.kmers` under ``config``, edge filter, kept-k-mer
    compaction."""
    import torch

    from seqwin_tpu_torch.graph import kept_node_layout
    from seqwin_tpu_torch.pipeline import kmers as pk

    t0 = time.perf_counter()
    graph, offsets, record_ids = build_fn(paths, targets)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    nodes = graph.nodes
    n_tar = sum(targets)
    n_neg = len(targets) - n_tar
    nodes['penalty'] = pk.frac_to_penalty(nodes['n_tar'] / n_tar, nodes['n_neg'] / n_neg)
    penalty_th = pk.penalty_threshold(*pk.minimizer_expectations(nodes, n_tar, n_neg), config)
    edge_weight_th = pk.edge_weight_threshold(penalty_th, n_tar, config)
    edges = graph.filter_edges(edge_weight_th)
    # compact the k-mers of the nodes that survive the edge filter
    # (pipeline/kmers.py:203), the superset of what subgraph search keeps
    keep_hashes = np.unique(np.concatenate([edges['first'], edges['second']]))
    keep, out_nodes, total = kept_node_layout(nodes, keep_hashes)
    kmers = graph.compact_kmers(keep, total)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return dict(graph=graph, nodes=nodes, edges=edges, kmers=kmers, total=total,
                secs=secs, build_s=t_build, penalty_th=float(penalty_th),
                edge_weight_th=float(edge_weight_th))


def check_main_run(run):
    """Output invariants of one main-path run."""
    nodes, edges, kmers, graph = run['nodes'], run['edges'], run['kmers'], run['graph']
    h = nodes['hash']
    if not np.all(h[1:] > h[:-1]):
        raise AssertionError('nodes not strictly sorted by unsigned hash')
    if int(np.sum(nodes['stop'] - nodes['start'])) != graph.n_kmers:
        raise AssertionError('node ranges do not cover the k-mer stream')
    full_edges = graph.materialize_edges()
    ef, es = full_edges['first'], full_edges['second']
    if not np.all(ef <= es):
        raise AssertionError('edge with first > second')
    if not np.all((ef[1:] > ef[:-1]) | ((ef[1:] == ef[:-1]) & (es[1:] > es[:-1]))):
        raise AssertionError('edges not strictly sorted by (first, second)')
    if len(kmers) != run['total']:
        raise AssertionError('kept k-mer count differs from the node layout total')
    if not (len(edges) and len(kmers)):
        raise AssertionError('empty filtered graph')
    return full_edges


def profile_run(build_fn, paths, targets, config, spans):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprof

    from seqwin_tpu_torch.engine import timeline

    # the package's spans reach the profiler only with the recorder on
    with timeline.recording(), tprof(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA]) as prof:
        main_path(build_fn, paths, targets, config)
    avg = prof.key_averages()
    log(avg.table(sort_by='cuda_time_total', row_limit=15))
    busy = device_busy_ms(avg)
    kernels = {'phase1_kernel' + e.key.split('phase1_kernel')[1][:3]:
               (e.count, e.self_device_time_total / 1e3)
               for e in avg if e.device_type != DeviceType.CPU and 'phase1_kernel' in e.key}
    log(f'[profile] device busy {busy:.3f} ms; phase-1 kernels '
        f'(launches, ms) {kernels}')
    log('[profile] host spans ' + json.dumps(host_spans(avg, spans)))


def device_busy_ms(avg) -> float:
    """Device time of a profile's `key_averages()`: kernels, copies and
    the profiler's own "Activity Buffer Request" row, less the annotations
    that mirror host spans (as the table's "Self CUDA time total" sums
    them)."""
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in avg if e.device_type != DeviceType.CPU
               and not getattr(e, 'is_user_annotation', False)) / 1e3


def host_spans(avg, spans) -> dict:
    """Calls and CPU ms of the package's spans in a profile's
    `key_averages()`. A span with device work inside also has a device-side
    entry of the same name and no CPU time: keep the CPU one."""
    return {name: max((dict(calls=e.count, cpu_ms=e.cpu_time_total / 1e3)
                       for e in avg if e.key == name),
                      key=lambda d: d['cpu_ms'], default=None)
            for name in spans}


def write_lists(td: Path, paths, targets) -> dict:
    """The target and non-target path lists of a run, as `Config` takes
    them."""
    lists = {}
    for key, want in (('tar_paths', True), ('neg_paths', False)):
        txt = td / f'{key}.txt'
        txt.write_text(''.join(f'{p}\n' for p, t in zip(paths, targets) if t == want))
        lists[key] = txt
    return lists


def main_data(td: Path, seed: int):
    """The 192 Mbp main-path dataset: 64 genomes x 3 Mbp, one record each."""
    t0 = time.perf_counter()
    paths, targets = synth(td, MAIN_GENOMES, MAIN_LEN, np.random.default_rng(seed + 2))
    log(f'[main] datagen {time.perf_counter() - t0:.1f} s ({MAIN_GENOMES} x {MAIN_LEN} bp)')
    return paths, targets


def phase_main(paths, targets, profile: bool, card: str, devices, td: Path) -> dict:
    """The 192 Mbp main path, single-device and multi-device over
    ``devices``; each run is driven with every launch count at 0 and read
    just after."""
    from seqwin_tpu_torch import Config
    from seqwin_tpu_torch.graph import build_deferred
    from seqwin_tpu_torch.graph.build import counters
    from seqwin_tpu_torch.parallel import build_distributed

    config = Config(**write_lists(td, paths, targets), prefix=td, run_mash=False, run_blast=False)

    def single(paths, targets):
        return build_deferred(paths, K, W, targets, n_cpu=8)

    def multi(paths, targets):
        return build_distributed(paths, K, W, targets, devices, n_cpu=8, defer=True)

    res = {}
    for label, fn, spans in (
            ('single', single, ('hybrid.host_prep', 'build.aggregate')),
            ('multi', multi, ('hybrid.host_prep', 'distributed.prepass',
                              'distributed.step', 'distributed.merge'))):
        reset_launches()
        run = main_path(fn, paths, targets, config)
        launches = read_launches()
        second = main_path(fn, paths, targets, config)
        if profile:
            profile_run(fn, paths, targets, config, spans)
        res[label] = dict(run=run, second=second, launches=launches)

    out = {}
    for label, r in res.items():
        run, second, launches = r['run'], r['second'], r['launches']
        graph = run['graph']
        full_edges = check_main_run(run)
        chunks = graph.n_chunks
        want = (want_launches(chunks, 0, 0) if label == 'single'
                else want_launches(0, chunks, chunks))
        if launches != want or not chunks:
            raise AssertionError(f'{label} main path launches {launches}, expected {want}')
        out[label] = dict(
            secs=run['secs'], secs_second=second['secs'], build_s=run['build_s'],
            build_s_second=second['build_s'], bases=MAIN_GENOMES * MAIN_LEN,
            minimizers=graph.n_kmers, nodes=graph.n_nodes, edges=graph.n_edges,
            kept_edges=len(run['edges']), kept_kmers=len(run['kmers']),
            launches=launches, penalty_th=run['penalty_th'],
            edge_weight_th=run['edge_weight_th'], chunks=chunks,
            minimizers_per_s=graph.n_kmers / second['secs'], full_edges=full_edges)
        shards = f' over {[str(d) for d in devices]}' if label == 'multi' else ''
        log(f"[main] {label}{shards} 192 Mbp k={K} w={W}: {run['secs']:.2f} s first run, "
            f"{second['secs']:.2f} s second (build {second['build_s']:.2f} s); "
            f"{out[label]['minimizers_per_s']:.4g} minimizers/s; minimizers={graph.n_kmers} "
            f"nodes={graph.n_nodes} edges={graph.n_edges} kept_edges={len(run['edges'])} "
            f"kept_kmers={len(run['kmers'])} chunks={chunks} launches={launches}; on {card}")
    s_run, m_run = res['single']['run'], res['multi']['run']
    if not (np.array_equal(s_run['nodes'], m_run['nodes'])
            and np.array_equal(out['single'].pop('full_edges'), out['multi'].pop('full_edges'))
            and np.array_equal(s_run['edges'], m_run['edges'])
            and np.array_equal(s_run['kmers'], m_run['kmers'])):
        raise AssertionError('multi-device 192 Mbp main path differs from the single-device one')
    log('[main] multi-device nodes, edges, filtered edges and kept k-mers equal the '
        'single-device run')
    counters['overflow_reruns'] = 0
    run, gaps = timeline_run(lambda: main_path(single, paths, targets, config))
    if not np.array_equal(run['nodes'], s_run['nodes']):
        raise AssertionError('192 Mbp build with the timeline on differs')
    out['single']['timeline'] = dict(secs=run['secs'], build_s=run['build_s'], gaps=gaps)
    log(f"[timeline] 192 Mbp single-device build_deferred with SEQWIN_TPU_TORCH_TIMELINE=1: "
        f"build {run['build_s']:.3f} s; overflow re-runs {counters['overflow_reruns']}; gaps "
        f"{json.dumps(gaps)}")
    prep = serial_prep_ms(paths, devices[0])
    out['single']['serial_prep_ms'] = prep
    log(f"[timeline] 192 Mbp host prep of the same chunks in series on the main thread "
        f"(`hybrid.pinned_host_prep`, host clock; torch.profiler does not see the prep pool's "
        f"threads): {json.dumps(prep)}; the threaded build ran from the first prep to the last "
        f"dispatch in {gaps['first_prep_to_last_dispatch_ms']:.1f} ms; on {card}")
    return out


def serial_prep_ms(paths, dev) -> dict:
    """Host ms of `hybrid.pinned_host_prep` for ``dev`` of each chunk of
    ``paths`` at the default budget, one after another on this thread: the
    prep work the build's pool spreads over its threads."""
    from seqwin_tpu_torch.engine import hybrid

    records, offsets = parse_records(paths)
    chunks = [(records[lo:hi], lo) for lo, hi in pack_chunks([len(r) for r in records])]
    times = []
    for recs, base in chunks:
        t0 = time.perf_counter()
        hybrid.pinned_host_prep(recs, K, W, base, offsets, dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return dict(sum=sum(times), max=max(times), n=len(times))


def proxy_data(td: Path, n_tar: int, n_neg: int, genome_len: int, seed: int,
               records_per_genome: int = 2):
    """The golden171 proxy (the reference's 171-genome run, re-made):
    targets from one random ancestor with 0.5% SNPs each, non-targets from
    an 8%-diverged root with 1%, each with one N run and cut into two
    records (or written whole, a complete genome, with
    ``records_per_genome=1``). Returns the `Config` path lists and the
    record lengths in scan order."""
    rng = np.random.default_rng(seed)
    ancestor = rng.integers(0, 4, size=genome_len).astype(np.uint8)
    neg_root = ancestor.copy()
    idx = rng.integers(0, genome_len, size=int(genome_len * 0.08))
    neg_root[idx] = (neg_root[idx] + rng.integers(1, 4, size=idx.size)) % 4
    paths, targets, rec_lens = [], [], []
    for i in range(n_tar + n_neg):
        is_tar = i < n_tar
        g = (ancestor if is_tar else neg_root).copy()
        idx = rng.integers(0, genome_len, size=int(genome_len * (0.005 if is_tar else 0.01)))
        g[idx] = (g[idx] + rng.integers(1, 4, size=idx.size)) % 4
        n0 = int(rng.integers(0, genome_len - 500))
        g[n0:n0 + int(rng.integers(10, 300))] = 4
        cut = int(rng.integers(genome_len // 4, 3 * genome_len // 4))
        parts = [g[:cut], g[cut:]] if records_per_genome == 2 else [g]
        p = td / f'{"tar" if is_tar else "neg"}_{i:03d}.fasta'
        write_fasta(p, [(f'proxy_{i}_{j}', r) for j, r in enumerate(parts)])
        paths.append(p)
        targets.append(is_tar)
        rec_lens += [len(r) for r in parts]
    return write_lists(td, paths, targets), rec_lens


def list_paths(lists: dict) -> list[Path]:
    """The FASTA paths of a run's path lists, targets first."""
    return [Path(ln) for key in ('tar_paths', 'neg_paths')
            for ln in lists[key].read_text().split()]


def expected_scans(records, budget: int) -> int:
    """Kernel B1 launches of the single-device build at chunk ``budget``:
    one per chunk of packed records, and one per block of each record above
    the budget (its `_record_block_plan`; one for a degenerate plan)."""
    from seqwin_tpu_torch.engine.hybrid import _record_block_plan

    scans, bases = 0, 0
    for c in records:
        if len(c) > budget:
            plan = _record_block_plan(c, K, W, budget)
            scans += (bases > 0) + (len(plan) if plan else 1)
            bases = 0
            continue
        if bases + len(c) > budget and bases:
            scans, bases = scans + 1, 0
        bases += len(c)
    return scans + (bases > 0)


def pack_chunks(lens, budget: int | None = None) -> list[tuple[int, int]]:
    """The single-device build's chunks of records of lengths ``lens`` (scan
    order, none above the budget) at ``budget`` (default: the build's
    `DEFAULT_CHUNK_BASES`): [(first record, end record), ...], a new chunk
    when the next record would pass the budget."""
    from seqwin_tpu_torch.graph.build import DEFAULT_CHUNK_BASES

    budget = budget or DEFAULT_CHUNK_BASES
    spans, lo, bases = [], 0, 0
    for i, n in enumerate(lens):
        if bases + n > budget and i > lo:
            spans.append((lo, i))
            lo, bases = i, 0
        bases += n
    return spans + [(lo, len(lens))] if len(lens) > lo else spans


FILES = ('signatures.fasta', 'signatures.csv', 'assemblies.csv')
_FINISHED = re.compile(r'Finished in (\d+):(\d+):([\d.]+)')
PHASES = ('build_graph', 'threshold', 'subgraphs', 'markers')


def log_phases(log_file: Path) -> dict:
    """Per-phase seconds from a run's `Finished in` lines, in pipeline
    order (the format `benchmarks/pipeline_e2e.py` reads)."""
    durs = [int(h) * 3600 + int(m) * 60 + float(sec)
            for h, m, sec in _FINISHED.findall(log_file.read_text())]
    return dict(zip(PHASES, durs))


def _differing(a: Path, b: Path, names) -> list:
    """The files of ``names`` whose bytes differ between run dirs a and b."""
    return [n for n in names if (a / n).read_bytes() != (b / n).read_bytes()]


def phase_pipeline_reduced(seed: int, td: Path) -> dict:
    """24 genomes x 1 Mbp (10 targets, 14 non-targets) in ``td``: `python -m
    seqwin_tpu_torch` on the card in a subprocess (run ``gpu``), against the
    port's CPU run in this process; signatures.fasta/.csv and
    assemblies.csv byte-equal, and the arrays of a --no-filter run's
    graph.npz. Returns the path lists and the record lengths."""
    from seqwin_tpu_torch import Config, run

    lists, rec_lens = proxy_data(td, 10, 14, 1_000_000, seed + 5)
    common = ['--tar-paths', str(lists['tar_paths']), '--neg-paths', str(lists['neg_paths']),
              '--prefix', str(td), '--no-mash', '--no-blast', '-p', '8']
    secs = {}
    for title, extra in (('gpu', []), ('gpu_raw', ['--no-filter'])):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, '-m', 'seqwin_tpu_torch', *common,
                              '--title', title, *extra],
                             cwd=REPO, capture_output=True, text=True, timeout=600)
        secs[title] = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f'python -m seqwin_tpu_torch ({title}) exited '
                                 f'{res.returncode}:\n{res.stderr[-3000:]}')
    # the host backend with no card visible: it needs none
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, '-m', 'seqwin_tpu_torch', *common, '--title',
                          'numpy', '--backend', 'numpy'], cwd=REPO, capture_output=True,
                         text=True, timeout=600, env={**os.environ, 'CUDA_VISIBLE_DEVICES': ''})
    secs['numpy'] = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f'python -m seqwin_tpu_torch --backend numpy exited '
                             f'{res.returncode}:\n{res.stderr[-3000:]}')
    for title, kw in (('cpu', {}), ('cpu_raw', dict(no_filter=True))):
        t0 = time.perf_counter()
        run(Config(**lists, prefix=td, title=title, run_mash=False, run_blast=False,
                   n_cpu=8, device='cpu', **kw))
        secs[title] = time.perf_counter() - t0
    differ = _differing(td / 'gpu', td / 'cpu', FILES)
    if differ:
        raise AssertionError(f'reduced pipeline: GPU CLI and CPU run differ in {differ}')
    differ = _differing(td / 'gpu', td / 'numpy', FILES)
    if differ:
        raise AssertionError(f'reduced pipeline: --backend numpy and the GPU CLI differ in {differ}')
    n_sig = (td / 'gpu' / 'signatures.fasta').read_bytes().count(b'>')
    gpu, cpu = np.load(td / 'gpu_raw' / 'graph.npz'), np.load(td / 'cpu_raw' / 'graph.npz')
    for key in ('kmers', 'nodes', 'edges', 'record_offsets'):
        if gpu[key].dtype != cpu[key].dtype or gpu[key].tobytes() != cpu[key].tobytes():
            raise AssertionError(f'reduced pipeline: --no-filter graph.npz {key} differs')
    if not n_sig:
        raise AssertionError('reduced pipeline: no signature')
    log(f'[pipeline] 24 x 1 Mbp: `python -m seqwin_tpu_torch --no-mash --no-blast -p 8` '
        f'on the card byte-equal to the CPU run: {n_sig} signatures, signatures.fasta, '
        f'signatures.csv, assemblies.csv; --no-filter graph.npz arrays equal '
        f'({len(gpu["kmers"])} minimizers); seconds '
        + ', '.join(f'{k} {v:.2f}' for k, v in secs.items()))
    log(f'[phase6 host-backend] 24 x 1 Mbp: `python -m seqwin_tpu_torch --backend numpy` '
        f'with CUDA_VISIBLE_DEVICES="" byte-equal to the GPU CLI run (signatures.fasta, '
        f"signatures.csv, assemblies.csv) in {secs['numpy']:.2f} s")
    return lists, rec_lens


def phase_pipeline_full(seed: int, profile: bool, card: str, td: Path) -> dict:
    """The golden171 proxy at its own scale, 72 + 99 genomes x 4.7 Mbp
    (~804 Mbp): `cli.main` in this process twice, -p 8, each driven with
    the launch counts at 0 and read just after; at least one signature, B1
    once per chunk, B2 and B3 never, the two runs byte-equal. With
    ``profile`` the second (timed) run carries `Config.profile_dir`."""
    import dataclasses

    import torch

    from seqwin_tpu_torch import cli, core
    from seqwin_tpu_torch.graph.build import counters

    n_tar, n_neg, genome_len = PROXY
    t0 = time.perf_counter()
    lists, rec_lens = proxy_data(td, n_tar, n_neg, genome_len, seed + 171)
    log(f'[pipeline] datagen {time.perf_counter() - t0:.1f} s '
        f'({n_tar} + {n_neg} x {genome_len} bp, {len(rec_lens)} records)')
    chunks = len(pack_chunks(rec_lens))
    runs = []
    for title in ('e2e_first', 'e2e'):
        argv = ['--tar-paths', str(lists['tar_paths']), '--neg-paths', str(lists['neg_paths']),
                '--prefix', str(td), '--title', title, '--no-mash', '--no-blast', '-p', '8']
        prof_dir = td / 'profile' if profile and title == 'e2e' else None

        def call():
            if prof_dir is None:
                return cli.main(argv)
            args = cli.build_parser().parse_args(argv)
            core.run(dataclasses.replace(cli.config_from_args(args), profile_dir=prof_dir))
            return 0

        torch.cuda.reset_peak_memory_stats()
        counters['overflow_reruns'] = 0
        reset_launches()
        t0 = time.perf_counter()
        # the second run records the build's timeline
        rc, gaps = timeline_run(call) if title == 'e2e' else (call(), None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = read_launches()
        if rc != 0:
            raise AssertionError(f'cli.main exited {rc} ({title})')
        want = want_launches(chunks, 0, 0)
        if launches != want:
            raise AssertionError(f'pipeline launches {launches}, expected {want}')
        out_dir = td / title
        log_text = (out_dir / 'seqwin.log').read_text()
        busy = re.search(r'Device busy ([\d.]+) ms', log_text) if prof_dir else None
        if prof_dir is not None and not ((prof_dir / 'trace.json').is_file() and busy):
            raise AssertionError('profiled pipeline run: no trace or no device-busy line')
        runs.append(dict(title=title, wall_s=wall, phases_s=log_phases(out_dir / 'seqwin.log'),
                         launches=launches, device_busy_ms=float(busy.group(1)) if busy else None,
                         n_signatures=(out_dir / 'signatures.fasta').read_bytes().count(b'>'),
                         peak_bytes=peak, timeline=gaps,
                         overflow_reruns=counters['overflow_reruns']))
    differ = _differing(td / 'e2e_first', td / 'e2e', FILES)
    if differ:
        raise AssertionError(f'full-scale pipeline: the two runs differ in {differ}')
    if not runs[0]['n_signatures']:
        raise AssertionError('full-scale pipeline: no signature')
    for r in runs:
        log(f"[pipeline] {n_tar} + {n_neg} x {genome_len} bp, cli.main -p 8 ({r['title']}): "
            f"{r['wall_s']:.2f} s wall; phases (s) {json.dumps(r['phases_s'])}; "
            f"{r['n_signatures']} signatures; launches {r['launches']} ({chunks} chunks, "
            f"{r['overflow_reruns']} overflow re-runs); peak "
            f"device memory {r['peak_bytes'] / 2**30:.2f} GiB"
            + (f"; device busy {r['device_busy_ms']:.3f} ms (torch.profiler)"
               if r['device_busy_ms'] is not None else '') + f'; on {card}')
    log('[pipeline] both runs byte-equal: signatures.fasta, signatures.csv, assemblies.csv')
    log(f"[timeline] 804 Mbp cli.main (e2e) with SEQWIN_TPU_TORCH_TIMELINE=1: gaps "
        f"{json.dumps(runs[-1]['timeline'])}")
    return dict(chunks=chunks, launches=runs[0]['launches'], runs=runs, lists=lists)


def phase_low_memory_cli(seed: int, profile: bool, card: str) -> dict:
    """Phase 6 (1): complete genomes, one record each, 72 + 99 x 4.7 Mbp:
    `cli.main` normal and with --low-memory, -p 8, each driven with the
    launch counts at 0; byte-equal files, B1 once per chunk (normal) or per
    block of the records' plans (low memory), B2 and B3 never. With
    ``profile`` a third, low-memory run is traced through
    `Config.profile_dir`."""
    import dataclasses

    import torch

    from seqwin_tpu_torch import cli, core
    from seqwin_tpu_torch.graph.build import DEFAULT_CHUNK_BASES, LOW_MEMORY_CHUNK_BASES

    n_tar, n_neg, genome_len = PROXY
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        t0 = time.perf_counter()
        lists, rec_lens = proxy_data(td, n_tar, n_neg, genome_len, seed + 6, records_per_genome=1)
        records, _ = parse_records(list_paths(lists))
        want_b1 = {'normal': expected_scans(records, DEFAULT_CHUNK_BASES),
                   'low_memory': expected_scans(records, LOW_MEMORY_CHUNK_BASES)}
        del records
        log(f'[phase6 low-memory] datagen and plans {time.perf_counter() - t0:.1f} s '
            f'({n_tar} + {n_neg} x {genome_len} bp, {len(rec_lens)} records, '
            f'{sum(n > LOW_MEMORY_CHUNK_BASES for n in rec_lens)} above the low-memory budget)')
        runs = {}
        titles = ['normal', 'low_memory'] + (['low_memory_traced'] if profile else [])
        for title in titles:
            argv = ['--tar-paths', str(lists['tar_paths']), '--neg-paths', str(lists['neg_paths']),
                    '--prefix', str(td), '--title', title, '--no-mash', '--no-blast', '-p', '8',
                    *([] if title == 'normal' else ['--low-memory'])]
            reset_launches()
            t0 = time.perf_counter()
            if title == 'low_memory_traced':
                args = cli.build_parser().parse_args(argv)
                core.run(dataclasses.replace(cli.config_from_args(args), profile_dir=td / 'profile'))
                rc = 0
            else:
                rc = cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
            if rc != 0:
                raise AssertionError(f'cli.main exited {rc} ({title})')
            want = want_launches(want_b1[title.removesuffix('_traced')], 0, 0)
            if launches != want:
                raise AssertionError(f'{title} complete-genome run launches {launches}, expected {want}')
            busy = re.search(r'Device busy ([\d.]+) ms', (td / title / 'seqwin.log').read_text())
            runs[title] = dict(wall_s=wall, phases_s=log_phases(td / title / 'seqwin.log'),
                               launches=launches, device_busy_ms=float(busy.group(1)) if busy else None,
                               n_signatures=(td / title / 'signatures.fasta').read_bytes().count(b'>'))
        for title in titles[1:]:
            differ = _differing(td / 'normal', td / title, FILES)
            if differ:
                raise AssertionError(f'complete genomes: {title} and the normal run differ in {differ}')
        if not runs['normal']['n_signatures']:
            raise AssertionError('complete genomes: no signature')
    for title, r in runs.items():
        log(f"[phase6 low-memory] {n_tar} + {n_neg} complete genomes x {genome_len} bp, cli.main "
            f"-p 8{'' if title == 'normal' else ' --low-memory'} ({title}): {r['wall_s']:.2f} s "
            f"wall; phases (s) {json.dumps(r['phases_s'])}; {r['n_signatures']} signatures; "
            f"launches {r['launches']}"
            + (f"; device busy {r['device_busy_ms']:.3f} ms (torch.profiler)"
               if r['device_busy_ms'] is not None else '') + f'; on {card}')
    log('[phase6 low-memory] --low-memory byte-equal to the normal run: ' + ', '.join(FILES))
    return runs


def phase_long_record(seed: int, devices, card: str) -> dict:
    """Phase 6 (2): one ~100 Mbp record and three short records (three
    assemblies): the default budget (the record in halo'd blocks), one
    2^27-base chunk, and `build_distributed` over ``devices`` (the record
    sequence-sharded), byte-equal, each held to its plan's launches."""
    import torch

    from seqwin_tpu_torch.graph import build
    from seqwin_tpu_torch.parallel import build_distributed
    from seqwin_tpu_torch.parallel.distributed import sharded_block_plan

    build_mod = sys.modules['seqwin_tpu_torch.graph.build']
    default_budget = build_mod.DEFAULT_CHUNK_BASES

    rng = np.random.default_rng(seed + 61)
    long_len = LONG_LEN
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        chrom = rng.integers(0, 4, size=long_len).astype(np.uint8)
        for s in rng.integers(0, long_len - 10_000, size=20):
            chrom[s:s + int(rng.integers(1, 10_000))] = 4
        short = [rng.integers(0, 4, size=n).astype(np.uint8) for n in (1_000_000, 500_000, 2_000_000)]
        paths = [td / 'chrom.fasta', td / 'a1.fasta', td / 'a2.fasta']
        write_fasta(paths[0], [('chrom', chrom)])
        write_fasta(paths[1], [('a1_0', short[0]), ('a1_1', short[1])])
        write_fasta(paths[2], [('a2_0', short[2])])
        targets = [True, True, False]
        records, _ = parse_records(paths)
        n_blocks = len(sharded_block_plan(records[0], K, W, len(devices)) or [None])
        results, runs = {}, {}
        for label, budget in (('blocks', None), ('one_chunk', 1 << 27)):
            build_mod.DEFAULT_CHUNK_BASES = budget or default_budget
            try:
                reset_launches()
                t0 = time.perf_counter()
                results[label] = build(paths, K, W, targets, n_cpu=8)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                launches = read_launches()
            finally:
                build_mod.DEFAULT_CHUNK_BASES = default_budget
            want = want_launches(expected_scans(records, budget or default_budget), 0, 0)
            if launches != want:
                raise AssertionError(f'long record ({label}) launches {launches}, expected {want}')
            runs[label] = dict(secs=secs, launches=launches)
        reset_launches()
        t0 = time.perf_counter()
        graph, offsets, ids = build_distributed(paths, K, W, targets, devices, n_cpu=8, defer=True)
        secs = time.perf_counter() - t0
        launches = read_launches()
        kmers, edges = graph.materialize()
        want = want_launches(n_blocks, graph.n_chunks, graph.n_chunks)
        if launches != want or not graph.n_chunks:
            raise AssertionError(f'sequence-sharded long record launches {launches}, expected {want}')
        runs['sharded'] = dict(secs=secs, launches=launches)
        check_no_sync(paths, devices)
    _assert_same_build('long record: blocks vs one chunk', results['blocks'], results['one_chunk'])
    _assert_same_build('long record: sequence-sharded vs blocks',
                       (kmers, graph.nodes, edges, offsets, ids), results['blocks'])
    n_kmers = len(results['blocks'][0])
    for label, r in runs.items():
        log(f"[phase6 long-record] {long_len} bp record + 3.5 Mbp, {label}"
            + (f" over {[str(d) for d in devices]}" if label == 'sharded' else '')
            + f": {r['secs']:.2f} s, launches {r['launches']}; on {card}")
    log(f'[phase6 long-record] blocks, one chunk and sequence sharding byte-equal '
        f'(kmers={n_kmers} nodes={len(graph.nodes)} edges={len(edges)})')
    return runs


def phase_multi_low_memory(paths, targets, devices, single) -> dict:
    """Phase 6 (3): the 192 Mbp data through `build_distributed` over
    ``devices`` with ``low_memory`` (whole-assembly batches of at least
    len(devices) x 2^22 bases, merged on the host), byte-equal to the
    single-device build ``single``; B2 and B3 once per shard stream with
    bases in each batch, B1 never."""
    import torch

    from seqwin_tpu_torch.graph.build import LOW_MEMORY_CHUNK_BASES
    from seqwin_tpu_torch.parallel import build_distributed
    from seqwin_tpu_torch.parallel.distributed import partition_records

    n_dev = len(devices)
    records, _ = parse_records(paths)  # one record per assembly here
    shards, batch = 0, []
    for n in [len(c) for c in records] + [None]:
        if n is not None:
            batch.append(n)
        if batch and (n is None or sum(batch) >= n_dev * LOW_MEMORY_CHUNK_BASES):
            of = partition_records(batch, n_dev)
            shards += sum(any(b for b, d in zip(batch, of) if d == j) for j in range(n_dev))
            batch = []
    del records
    reset_launches()
    t0 = time.perf_counter()
    graph, offsets, ids = build_distributed(paths, K, W, targets, devices, n_cpu=8, defer=True,
                                            low_memory=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    kmers, edges = graph.materialize()
    _assert_same_build('multi-device low memory vs single-device build',
                       (kmers, graph.nodes, edges, offsets, ids), single)
    want = want_launches(0, shards, shards)
    if launches != want or graph.n_chunks != shards:
        raise AssertionError(f'multi-device low memory launches {launches}, expected {want}')
    log(f'[phase6 multi-low-memory] 192 Mbp over {[str(d) for d in devices]} with low_memory: '
        f'byte-equal to the single-device build in {secs:.2f} s; launches {launches}')
    return dict(secs=secs, launches=launches)


_THRESHOLD = re.compile(r'calculated penalty threshold: ([\d.]+)')


def penalty_threshold_of(log_file: Path) -> float:
    """The penalty threshold a run computed, from its `seqwin.log`."""
    return float(_THRESHOLD.search(log_file.read_text()).group(1))


def list_targets(lists: dict) -> list[bool]:
    """The target flags of `list_paths(lists)`."""
    return [key == 'tar_paths' for key in ('tar_paths', 'neg_paths')
            for _ in lists[key].read_text().split()]


def parse_assemblies(paths) -> list[list[np.ndarray]]:
    """Per assembly, its parsed record codes."""
    from seqwin_tpu_torch.io.fasta import iter_assemblies

    return [codes for _, codes in iter_assemblies([str(p) for p in paths], 8)]


def phase_sketch_reduced(lists: dict, rec_lens, td: Path, devices, card: str) -> dict:
    """Phase 7 (1) and (3) on phase 5's reduced proxy in ``td``: `cli.main
    --sketch-mode device` on the card, plain and with ``--seed-pattern``,
    each against the port's CPU run with the same options (the three files
    byte-equal; B1 once per chunk); then `build_distributed(...,
    keep_codes=True)` over ``devices``, its kept codes equal to the
    parse."""
    import torch

    from seqwin_tpu_torch import Config, cli, run
    from seqwin_tpu_torch.parallel import build_distributed

    common = ['--tar-paths', str(lists['tar_paths']), '--neg-paths', str(lists['neg_paths']),
              '--prefix', str(td), '--no-mash', '--no-blast', '-p', '8', '--sketch-mode', 'device']
    chunks = len(pack_chunks(rec_lens))
    cuts = expected_cuts(parse_assemblies(list_paths(lists)))
    out = {}
    for label, pattern in (('sketch', None), ('sketch_seed', SEED_PATTERN)):
        extra = ['--seed-pattern', pattern] if pattern else []
        reset_launches()
        t0 = time.perf_counter()
        rc = cli.main([*common, '--title', f'gpu_{label}', *extra])
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
        launches = read_launches()
        if rc != 0:
            raise AssertionError(f'cli.main --sketch-mode device ({label}) exited {rc}')
        # contiguous k-mers take the cut (one sketch_cut a chunk, one
        # sketch_select a job); a seed pattern the torch path
        want = want_launches(chunks, 0, 0, *((cuts, 1) if pattern is None else (0, 0)))
        if launches != want:
            raise AssertionError(f'{label} reduced CLI launches {launches}, expected {want}')
        t0 = time.perf_counter()
        run(Config(**lists, prefix=td, title=f'cpu_{label}', run_mash=False, run_blast=False,
                   n_cpu=8, device='cpu', sketch_mode='device', seed_pattern=pattern))
        cpu_s = time.perf_counter() - t0
        differ = _differing(td / f'gpu_{label}', td / f'cpu_{label}', FILES)
        if differ:
            raise AssertionError(f'--sketch-mode device ({label}): card and CPU runs differ in {differ}')
        n_sig = (td / f'gpu_{label}' / 'signatures.fasta').read_bytes().count(b'>')
        if not n_sig:
            raise AssertionError(f'--sketch-mode device ({label}): no signature')
        out[label] = dict(gpu_s=gpu_s, cpu_s=cpu_s, launches=launches, n_signatures=n_sig,
                          penalty_th=penalty_threshold_of(td / f'gpu_{label}' / 'seqwin.log'))
        log(f"[phase7 sketch] 24 x 1 Mbp: cli.main {' '.join(['--sketch-mode', 'device', *extra])} on the "
            f"card byte-equal to the CPU run ({', '.join(FILES)}): {n_sig} signatures, threshold "
            f"{out[label]['penalty_th']} (minimizer estimate "
            f"{penalty_threshold_of(td / 'gpu' / 'seqwin.log')}); card {gpu_s:.2f} s, CPU "
            f'{cpu_s:.2f} s; launches {launches}; on {card}')

    paths, targets = list_paths(lists), list_targets(lists)
    reset_launches()
    t0 = time.perf_counter()
    graph, _, _ = build_distributed(paths, K, W, targets, devices, n_cpu=8, defer=True,
                                    keep_codes=True)
    secs = time.perf_counter() - t0
    launches = read_launches()
    want = parse_assemblies(paths)
    if len(graph.record_codes) != len(want) or not all(
            len(g) == len(w) and all(a.dtype == b.dtype and np.array_equal(a, b)
                                     for a, b in zip(g, w))
            for g, w in zip(graph.record_codes, want)):
        raise AssertionError('build_distributed(keep_codes=True): kept codes differ from the parse')
    if launches != want_launches(0, graph.n_chunks, graph.n_chunks):
        raise AssertionError(f'build_distributed(keep_codes=True) launches {launches}')
    out['keep_codes'] = dict(secs=secs, launches=launches)
    log(f'[phase7 keep-codes] 24 x 1 Mbp build_distributed(keep_codes=True) over '
        f'{[str(d) for d in devices]}: the codes of {len(want)} assemblies equal the parse; '
        f'{secs:.2f} s, launches {launches}')
    return out


def phase_sketch_full(td: Path, pipe: dict, card: str, profile: bool) -> dict:
    """Phase 7 (2) on phase 5's 804 Mbp proxy in ``td``: `cli.main
    --sketch-mode device`, B1 once per chunk, wall time, `Finished in`
    seconds and the threshold against the minimizer estimate of phase 5's
    ``e2e`` run; then the card's sketches of every assembly and their
    Jaccard matrix timed alone (the parse before them not timed), the
    sketches of `SKETCHES_HELD` and the whole matrix equal to the CPU's.
    ``profile`` traces the sketches once more (device busy)."""
    import torch

    from seqwin_tpu_torch import cli
    from seqwin_tpu_torch.mash import device_sketches, sketch_jaccard_matrix

    lists, chunks = pipe['lists'], pipe['chunks']
    records = parse_assemblies(list_paths(lists))
    cuts = expected_cuts(records)
    reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(['--tar-paths', str(lists['tar_paths']), '--neg-paths', str(lists['neg_paths']),
                   '--prefix', str(td), '--title', 'e2e_sketch', '--no-mash', '--no-blast', '-p',
                   '8', '--sketch-mode', 'device'])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    if rc != 0:
        raise AssertionError(f'cli.main --sketch-mode device exited {rc} (804 Mbp)')
    want = want_launches(chunks, 0, 0, cuts, 1)
    if launches != want:
        raise AssertionError(f'804 Mbp --sketch-mode device launches {launches}, expected {want}')
    log_file = td / 'e2e_sketch' / 'seqwin.log'
    n_sig = (td / 'e2e_sketch' / 'signatures.fasta').read_bytes().count(b'>')
    res = dict(wall_s=wall, phases_s=log_phases(log_file), launches=launches, n_signatures=n_sig,
               penalty_th=penalty_threshold_of(log_file),
               minimizer_penalty_th=penalty_threshold_of(td / 'e2e' / 'seqwin.log'),
               minimizer_phases_s=pipe['runs'][-1]['phases_s'])
    log(f"[phase7 sketch] {PROXY[0]} + {PROXY[1]} x {PROXY[2]} bp, cli.main -p 8 --sketch-mode "
        f"device: {wall:.2f} s wall; phases (s) {json.dumps(res['phases_s'])}; threshold "
        f"{res['penalty_th']} (minimizer estimate {res['minimizer_penalty_th']}, phases (s) "
        f"{json.dumps(res['minimizer_phases_s'])}); {n_sig} signatures; launches {launches}; "
        f'on {card}')

    torch.cuda.synchronize()
    reset_launches()
    cut = {}
    t0 = time.perf_counter()
    sketches = device_sketches(records, K, SKETCH_SIZE, device='cuda', stats=cut)
    res['sketches_s'] = time.perf_counter() - t0
    res['sketch_launches'] = read_launches()
    res.update(cut)
    if res['sketch_launches'] != want_launches(0, 0, 0, cuts, 1):
        raise AssertionError(f"804 Mbp sketches launches {res['sketch_launches']}, expected "
                             f'{cuts} sketch_cut and 1 sketch_select')
    if cut.get('fallbacks') != 0:
        raise AssertionError(f'804 Mbp sketches: the cut redid {cut.get("fallbacks")} assemblies '
                             'on the torch path (expected none)')
    t0 = time.perf_counter()
    mtx = sketch_jaccard_matrix(sketches, SKETCH_SIZE, device='cuda')
    res['matrix_s'] = time.perf_counter() - t0
    if any(len(s) != SKETCH_SIZE for s in sketches):
        raise AssertionError('804 Mbp sketches: an assembly with fewer distinct hashes than the size')
    for i in SKETCHES_HELD:
        cpu = device_sketches(records[i:i + 1], K, SKETCH_SIZE, device='cpu')[0]
        if cpu.dtype != sketches[i].dtype or not np.array_equal(cpu, sketches[i]):
            raise AssertionError(f'804 Mbp sketches: assembly {i} differs between card and CPU')
    if not np.array_equal(sketch_jaccard_matrix(sketches, SKETCH_SIZE, device='cpu'), mtx):
        raise AssertionError('804 Mbp Jaccard matrix differs between card and CPU')
    n = len(records)
    log(f"[phase7 sketch] {n} assemblies, {sum(len(c) for r in records for c in r)} bases: "
        f"sketches on the card {res['sketches_s']:.3f} s ({res['sketches_s'] / n * 1e3:.2f} ms "
        f"per assembly), Jaccard matrix {n} x {n} {res['matrix_s']:.3f} s (float64); sketches "
        f'of assemblies {list(SKETCHES_HELD)} and the whole matrix equal to the CPU; cut '
        f"{res['candidates']} candidates, {res['fallbacks']} fallbacks, launches "
        f"{res['sketch_launches']}; on {card}")
    res['kernels'] = phase_sketch_kernels(records, card)
    if profile:
        from torch.profiler import ProfilerActivity, profile as tprof

        with tprof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            device_sketches(records, K, SKETCH_SIZE, device='cuda')
            torch.cuda.synchronize()
        avg = prof.key_averages()
        log(avg.table(sort_by='cuda_time_total', row_limit=12))
        res['sketches_device_busy_ms'] = device_busy_ms(avg)
        log(f"[phase7 profile] sketches of {n} assemblies traced: device busy "
            f"{res['sketches_device_busy_ms']:.3f} ms")
    return res


def phase_sketch_kernels(records, card: str) -> list[dict]:
    """Phase 7 (2), the sketch kernels alone on the 804 Mbp proxy's
    assemblies (``records``), chunked as `mash.cut_sketches` chunks them:
    `sketch_cut` against `sketch_cut_plain` on every chunk (equal counters,
    equal sets of kept values), `sketch_select` against
    `sketch_select_plain` on the kernel's candidates (equal rows), both
    versions on the card; each kernel timed with CUDA events (`sketch_cut`
    summed over the chunks, each launch after a reset of its counters),
    against its bound: `portbench/sketch_peaks.py`'s for `sketch_cut` (the
    whole estimator's least work over the records' bases), and for
    `sketch_select`, which that bound leaves out, its candidates read and
    its rows written once at the memory rate."""
    import torch

    from portbench.peaks import HBM_BYTES_PER_S as PEAK_BYTES_PER_S
    from portbench.sketch_peaks import sketch_bound_s
    from seqwin_tpu_torch import mash

    dev = torch.device('cuda')
    lengths = [mash.stream_bases(r) for r in records]
    n_asm, plan = len(lengths), mash.chunk_plan(lengths, mash.CHUNK_BASES)
    rows = mash.cut_rows(lengths, plan, SKETCH_SIZE)
    rows_dev = torch.from_numpy(rows).to(dev)
    cap = mash.cand_cap(SKETCH_SIZE)
    counts, counts_p, scratch = (torch.zeros(n_asm, dtype=torch.int32, device=dev)
                                 for _ in range(3))
    cand, cand_p, cand_t = (torch.full((n_asm * cap,), -1, dtype=torch.int64, device=dev)
                            for _ in range(3))
    cut_ms = plain_ms = 0.0
    for a0, a1 in plan:
        buf = np.empty(int(rows[a1 - 1, 0] + rows[a1 - 1, 1]), np.uint8)
        mash.stage_chunk(buf, records[a0:a1], rows[a0:a1, 0])
        codes = torch.from_numpy(buf).to(dev)
        blocks = int(rows[a1 - 1, 2]) + -(-lengths[a1 - 1] // mash.CUT_TILE)
        part = slice(a0 * cap, a1 * cap)
        mash.sketch_cut(codes, rows_dev[a0:a1], K, cand[part], counts[a0:a1], cap, blocks)

        def launch():
            scratch[a0:a1].zero_()
            mash.sketch_cut(codes, rows_dev[a0:a1], K, cand_t[part], scratch[a0:a1], cap, blocks)

        cut_ms += cuda_ms(launch, iters=5)
        plain_ms += cuda_ms(lambda: mash.sketch_cut_plain(
            codes, rows_dev[a0:a1], K, cand_p[part], counts_p[a0:a1].zero_(), cap),
            iters=1, warmup=0)
    torch.cuda.synchronize()
    if not torch.equal(counts, counts_p):
        bad = torch.nonzero(counts != counts_p).flatten().tolist()
        raise AssertionError(f'sketch_cut: counters differ from the plain version at {bad[:8]}')
    kept, kept_p = cand.view(n_asm, cap), cand_p.view(n_asm, cap)
    for a, c in enumerate(counts.tolist()):
        m = min(c, cap)
        if not torch.equal(torch.sort(kept[a, :m]).values, torch.sort(kept_p[a, :m]).values):
            raise AssertionError(f'sketch_cut: assembly {a} kept other values than the plain version')
    out = mash.sketch_select(cand, counts, cap, SKETCH_SIZE)
    out_p = mash.sketch_select_plain(cand, counts, cap, SKETCH_SIZE)
    torch.cuda.synchronize()
    if not torch.equal(out, out_p):
        raise AssertionError('sketch_select: rows differ from the plain version')
    select_ms = cuda_ms(lambda: mash.sketch_select(cand, counts, cap, SKETCH_SIZE), iters=20)
    select_plain_ms = cuda_ms(lambda: mash.sketch_select_plain(cand, counts, cap, SKETCH_SIZE),
                              iters=1, warmup=0)
    bases = sum(len(c) for r in records for c in r)
    n = int(sum(rows[a1 - 1, 0] + rows[a1 - 1, 1] for _, a1 in plan))  # positions, separators too
    kept_n = int(counts.clamp(max=cap).sum())
    cut_bound = sketch_bound_s(bases) * 1e3
    select_bound = (8 * kept_n + 8 * (SKETCH_SIZE + 2) * n_asm) / PEAK_BYTES_PER_S * 1e3
    res = [
        dict(name='sketch_cut', route='cuda', source='seqwin_tpu_torch/csrc/sketch.cu',
             replaces='none: new in the port', launches=len(plan), mismatches=0,
             max_abs_err=0.0, n=n, bases=bases, ms=cut_ms, plain_ms=plain_ms,
             bound_ms=cut_bound, bound_by='operations (portbench/sketch_peaks.py)',
             library_ms=None, candidates=int(counts.sum())),
        dict(name='sketch_select', route='cuda', source='seqwin_tpu_torch/csrc/sketch.cu',
             replaces='none: new in the port', launches=1, mismatches=0, max_abs_err=0.0,
             n=kept_n, assemblies=n_asm, ms=select_ms, plain_ms=select_plain_ms,
             bound_ms=select_bound, bound_by='bytes (candidates read, rows written)',
             library_ms=None),
    ]
    for r in res:
        log(f"[phase7 kernel] {r['name']} on the {n_asm} assemblies ({len(plan)} chunks, "
            f"{bases} bases, {int(counts.sum())} candidates): equal to its plain version; "
            f"kernel {r['ms']:.4f} ms a job, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms'] * 1e3:.1f} us by {r['bound_by']}; on {card}")
    return res


def build_digest(res) -> str:
    """SHA-256 of a build's (kmers, nodes, edges, record_offsets, record_ids)."""
    h = hashlib.sha256()
    for a in res[:4]:
        h.update(str(a.dtype).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(json.dumps([list(t) for t in res[4]]).encode())
    return h.hexdigest()


def worker(task_file: str, rank: int) -> int:
    """One process of phase 8: rank ``rank`` of the gloo group at the
    task's port. `graph.build_deferred` of the 192 Mbp data plain, with
    ``low_memory`` and plain again (warm), then the reduced CLI plain and
    with ``--sketch-mode device``, each with the launch counts at 0 and read
    just after; with the task's ``profile`` one more plain build traced
    (device busy, the package's host spans). Writes the seconds, launches
    and build digests to ``result.json`` under the rank's prefix."""
    task = json.loads(Path(task_file).read_text())
    os.environ['SEQWIN_TPU_MULTIHOST'] = f"127.0.0.1:{task['port']},2,{rank}"
    sys.path.insert(0, str(REPO))
    import torch
    import torch.distributed as tdist

    from seqwin_tpu_torch import cli
    from seqwin_tpu_torch.graph import build_deferred

    def multihost_build(low_memory: bool) -> dict:
        reset_launches()
        t0 = time.perf_counter()
        graph, offsets, ids = build_deferred(task['paths'], K, W, task['targets'], n_cpu=8,
                                             low_memory=low_memory)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()
        kmers, edges = graph.materialize()
        return dict(secs=secs, launches=launches, n_chunks=graph.n_chunks,
                    digest=build_digest((kmers, graph.nodes, edges, offsets, ids)))

    # the first build pays this process's first use of the card
    out = {label: multihost_build(low_memory)
           for label, low_memory in (('plain', False), ('low_memory', True), ('plain_warm', False))}
    if task['profile']:
        from torch.profiler import ProfilerActivity, profile as tprof

        from seqwin_tpu_torch.engine import timeline

        with timeline.recording(), tprof(activities=[ProfilerActivity.CPU,
                                                     ProfilerActivity.CUDA]) as prof:
            multihost_build(False)
        avg = prof.key_averages()
        out['profile'] = dict(device_busy_ms=device_busy_ms(avg), spans=host_spans(avg, (
            'multihost.parse', 'hybrid.host_prep', 'distributed.prepass', 'distributed.step',
            'distributed.exchange', 'distributed.merge', 'distributed.gather')))
    prefix = Path(task['prefix']) / f'rank{rank}'
    prefix.mkdir(parents=True)
    for title, extra in (('gpu', []), ('gpu_sketch', ['--sketch-mode', 'device'])):
        reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(['--tar-paths', task['tar_paths'], '--neg-paths', task['neg_paths'],
                       '--prefix', str(prefix), '--title', title, '--no-mash', '--no-blast',
                       '-p', '8', *extra])
        torch.cuda.synchronize()
        out[title] = dict(rc=rc, secs=time.perf_counter() - t0, launches=read_launches())
    (prefix / 'result.json').write_text(json.dumps(out))
    tdist.destroy_process_group()
    return 0


def phase_multi_host(paths, targets, single, single_s: float, lists: dict, reduced: Path,
                     td: Path, card: str, profile: bool) -> dict:
    """Phase 8: two OS processes on the card (`worker`), ranks of one gloo
    group through ``SEQWIN_TPU_MULTIHOST=127.0.0.1:<port>,2,<rank>``. Both
    processes' 192 Mbp builds, plain and low memory, byte-equal to the
    single-device build ``single`` (SHA-256 digests); B2 and B3 once per
    batch in which the process holds bases, B1 never; the reduced CLI runs
    of both byte-equal to the single-process runs in ``reduced`` (phase 5's
    ``gpu``, phase 7's ``gpu_sketch``). ``profile`` traces one more build
    in each process."""
    import torch

    from seqwin_tpu_torch.graph.build import LOW_MEMORY_CHUNK_BASES
    from seqwin_tpu_torch.parallel.multihost import _size_batches, partition_indices

    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    task = dict(port=port, paths=[str(p) for p in paths], targets=list(targets),
                tar_paths=str(lists['tar_paths']), neg_paths=str(lists['neg_paths']),
                prefix=str(td / 'multihost'), profile=profile)
    task_file = td / 'multihost_task.json'
    task_file.write_text(json.dumps(task))
    env = {**os.environ}
    env.setdefault('GLOO_SOCKET_IFNAME', 'lo')  # both ranks on this host
    logs = [td / f'multihost_rank{r}.log' for r in range(2)]
    t0 = time.perf_counter()
    procs = []
    try:
        for r in range(2):
            with open(logs[r], 'w') as f:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), '--worker', str(task_file),
                     str(r)], cwd=REPO, env=env, stdout=f, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + 600
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f'multi-host worker {r} exited {p.returncode}:\n'
                                 f'{logs[r].read_text()[-4000:]}')

    want_digest = build_digest(single)
    cuts = expected_cuts(parse_assemblies(list_paths(lists)))
    sizes = [Path(p).stat().st_size for p in paths]
    one_card = torch.cuda.device_count() == 1
    batches = _size_batches(task['paths'], sizes, 2 * LOW_MEMORY_CHUNK_BASES)
    out = {'wall_s': wall, 'single_s': single_s}
    for r in range(2):
        res = json.loads((td / 'multihost' / f'rank{r}' / 'result.json').read_text())
        for label in ('plain', 'low_memory', 'plain_warm'):
            b = res[label]
            if b['digest'] != want_digest:
                raise AssertionError(f'multi-host {label} build of rank {r} differs from the '
                                     'single-device build')
            owned = (sum(bool(partition_indices(sizes[lo:hi], 2, r)) for lo, hi in batches)
                     if label == 'low_memory' else 1)
            want = want_launches(0, b['n_chunks'], b['n_chunks'])
            if b['launches'] != want or not b['n_chunks'] or (one_card and b['n_chunks'] != owned):
                raise AssertionError(f'multi-host {label} rank {r} launches {b["launches"]} '
                                     f'({b["n_chunks"]} shard streams), expected {want}, '
                                     f'{owned} with one card per process')
        for title in ('gpu', 'gpu_sketch'):
            c = res[title]
            if c['rc'] != 0:
                raise AssertionError(f'multi-host CLI ({title}) of rank {r} exited {c["rc"]}')
            differ = _differing(reduced / title, td / 'multihost' / f'rank{r}' / title, FILES)
            if differ:
                raise AssertionError(f'multi-host CLI ({title}) of rank {r} differs from the '
                                     f'single-process run in {differ}')
            sketch = (cuts, 1) if title == 'gpu_sketch' else (0, 0)
            if (c['launches']['phase1_z'] or not c['launches']['phase1_zc']
                    or (c['launches']['sketch_cut'], c['launches']['sketch_select']) != sketch):
                raise AssertionError(f'multi-host CLI ({title}) rank {r} launches {c["launches"]}, '
                                     f'expected (sketch_cut, sketch_select) = {sketch}')
        out[f'rank{r}'] = res
        log(f"[phase8 multi-host] rank {r} of 2 on {torch.cuda.get_device_name(0)}: 192 Mbp "
            f"graph.build byte-equal to the single-device build, plain {res['plain']['secs']:.2f} s "
            f"(warm {res['plain_warm']['secs']:.2f} s) launches {res['plain']['launches']}, "
            f"low_memory {res['low_memory']['secs']:.2f} s launches "
            f"{res['low_memory']['launches']}; reduced CLI byte-equal to the "
            f"single-process runs ({', '.join(FILES)}), plain {res['gpu']['secs']:.2f} s "
            f"launches {res['gpu']['launches']}, --sketch-mode device "
            f"{res['gpu_sketch']['secs']:.2f} s; on {card}")
        if profile:
            log(f'[phase8 profile] rank {r}: traced warm build, device busy '
                f"{res['profile']['device_busy_ms']:.3f} ms; host spans "
                + json.dumps(res['profile']['spans']))
    log(f'[phase8 multi-host] two processes {wall:.2f} s wall (start-up included); the '
        f'single-device 192 Mbp graph.build {single_s:.2f} s')
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--profile', action='store_true',
                    help='trace one more run of each main path with torch.profiler')
    ap.add_argument('--worker', nargs=2, metavar=('TASK', 'RANK'),
                    help='run as one process of phase 8 (started by this script)')
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    try:
        import seqwin_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f'chip_smoke: seqwin_tpu_torch not importable from {REPO}: {e}', file=sys.stderr)
        return 1
    if args.worker:
        return worker(args.worker[0], int(args.worker[1]))
    # the package's INFO lines go to each run's seqwin.log, not to stdout
    for handler in logging.getLogger().handlers:
        if isinstance(handler, logging.StreamHandler) and not isinstance(handler, logging.FileHandler):
            handler.setLevel(logging.WARNING)

    from seqwin_tpu_torch.graph import build

    name = torch.cuda.get_device_name(0)
    card = smi()
    devices = shard_devices()
    log(f'[env] {name} x{torch.cuda.device_count()}; torch {torch.__version__} '
        f'cuda {torch.version.cuda}; {card}; shards D = {[str(d) for d in devices]} '
        f"({'one card repeated' if len(set(devices)) == 1 else 'distinct cards'})")
    phase_build()
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        paths, targets = main_data(td, args.seed)
        kernels = phase_kernels(args.seed, first_shard_stream(paths, devices))
        phase_small(args.seed, devices)
        main_res = phase_main(paths, targets, args.profile, card, devices, td)
        t0 = time.perf_counter()
        single = build(paths, K, W, targets, n_cpu=8)
        single_s = time.perf_counter() - t0
        multi_low = phase_multi_low_memory(paths, targets, devices, single)
        reduced = td / 'reduced'
        reduced.mkdir()
        lists, rec_lens = phase_pipeline_reduced(args.seed, reduced)
        sketch_reduced = phase_sketch_reduced(lists, rec_lens, reduced, devices, card)
        multi_host = phase_multi_host(paths, targets, single, single_s, lists, reduced, td, card,
                                      args.profile)
        del single
    with tempfile.TemporaryDirectory() as td:
        pipe = phase_pipeline_full(args.seed, args.profile, card, Path(td))
        sketch_full = phase_sketch_full(Path(td), pipe, card, args.profile)
    low = phase_low_memory_cli(args.seed, args.profile, card)
    long_rec = phase_long_record(args.seed, devices, card)
    for kern in kernels:
        kname = kern['name']
        path = 'single' if kname == 'phase1_z' else 'multi'
        kern['launches'] = main_res[path]['launches'][kname]
        kern['pipeline_launches'] = pipe['launches'][kname]
        kern['phase6_launches'] = {
            'complete_genomes_normal': low['normal']['launches'][kname],
            'complete_genomes_low_memory': low['low_memory']['launches'][kname],
            **{f'long_record_{k}': v['launches'][kname] for k, v in long_rec.items()},
            'multi_device_low_memory': multi_low['launches'][kname]}
        kern['phase7_launches'] = {
            'cli_sketch_device_804mbp': sketch_full['launches'][kname],
            **{f'cli_{k}_24mbp': v['launches'][kname] for k, v in sketch_reduced.items()
               if k != 'keep_codes'},
            'keep_codes_multi_device': sketch_reduced['keep_codes']['launches'][kname]}
        kern['phase8_launches'] = {
            f'rank{r}_{label}': multi_host[f'rank{r}'][run]['launches'][kname]
            for r in range(2) for label, run in (('build', 'plain'), ('build_low_memory', 'low_memory'),
                                                 ('cli', 'gpu'), ('cli_sketch_device', 'gpu_sketch'))}
    for kern in sketch_full['kernels']:
        kname = kern['name']
        kern['phase7_launches'] = {
            'cli_sketch_device_804mbp': sketch_full['launches'][kname],
            'sketches_804mbp': sketch_full['sketch_launches'][kname],
            **{f'cli_{k}_24mbp': v['launches'][kname] for k, v in sketch_reduced.items()
               if k != 'keep_codes'}}
        kern['phase8_launches'] = {
            f'rank{r}_cli_sketch_device': multi_host[f'rank{r}']['gpu_sketch']['launches'][kname]
            for r in range(2)}
        kernels.append(kern)
    log(json.dumps({'kernels': kernels}))
    log(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name, 'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
