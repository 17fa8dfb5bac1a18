#!/usr/bin/env python3
"""A/B of the emission extraction in seqwin_tpu_torch's multi-device build
step, on one CUDA GPU.

Run from the repository root on a machine with an H100 and nvcc:

    python3 torch_extract_ab.py [--seed 0] [--reps 3]

The multi-device build step extracts each shard's emissions with the pfx
route: kernel B3 (`phase1_pfx`) and `hybrid.scan_phase2_pfx`. This script
times it against the mask route sized from the count pre-pass: kernel B1
(`phase1_z`), the host patches, the emission mask and
`torch.nonzero_static` at the pre-pass's exact count, which needs no sync
either. Both routes feed the same routing and exchange
(`distributed._route_shard`). On the 192 Mbp main path of `chip_smoke.py`
over the same shard devices it prints, per rep and in the order pfx, mask,
mask, pfx:

- the build step alone over every shard (CUDA events around the host's
  enqueue of all shards, so device idle time counts);
- the wall seconds of `build_distributed_arrays` from parsed records.

It checks that both routes give the same arrays, prints the card's name and
power limit, and ends with one JSON line. The package has no way to select
the mask route: it exists here only to be measured.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from chip_smoke import (K, MAIN_GENOMES, MAIN_LEN, W, cuda_ms, log, parse_records,
                        shard_devices, smi, synth)


def mask_shard_step(shard, k: int, w: int, emit_cap: int, count: int,
                    e_sizes: list[int], p_sizes: list[int], devices):
    """`distributed._shard_step` with the mask extraction sized from the
    pre-pass count in place of the pfx route."""
    import torch

    from seqwin_tpu_torch.engine import hybrid
    from seqwin_tpu_torch.engine.phase1 import phase1_z
    from seqwin_tpu_torch.parallel import distributed as dist

    z = phase1_z(shard['codes'], k, w)
    z[shard['patch_pos'].long()] = shard['patch_z']
    emit = hybrid._emission_mask(z)
    # the emitted values: the minimizer positions at the emitting flags
    eidx = z.long()[torch.nonzero_static(emit, size=count).squeeze(1)]
    e_oh, e_pos, e_rec, e_asm = hybrid._emitted_streams(
        shard['codes'], eidx, k, shard['starts'], shard['rec_base'], shard['asm_tab'])
    node_blocks, pair_blocks, e_counts, p_counts = dist._route_shard(
        e_oh, e_pos, e_rec, e_asm, e_sizes, p_sizes, devices)
    checks = {'emission counts': (emit.sum(), count),
              'minimizer block sizes': (e_counts, e_sizes),
              'pair block sizes': (p_counts, p_sizes)}
    return node_blocks, pair_blocks, checks


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--reps', type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print('torch_extract_ab: no CUDA device available', file=sys.stderr)
        return 1
    from seqwin_tpu_torch.parallel import distributed as dist

    card = smi()
    devices = shard_devices()
    n_dev = len(devices)
    variants = {'pfx': dist._shard_step, 'mask': mask_shard_step}
    with tempfile.TemporaryDirectory() as td:
        paths, targets = synth(Path(td), MAIN_GENOMES, MAIN_LEN, np.random.default_rng(args.seed + 2))
        records, offsets = parse_records(paths)
    shards = dist._shard_layout(records, dist.partition_records([len(c) for c in records], n_dev),
                                devices, K, W, offsets)
    counts, e_hist, p_hist = dist._read_prepass(dist._prepass(shards, K, W, n_dev), n_dev)
    log(f'[ab] {card}; shards D = {[str(d) for d in devices]}; '
        f'{MAIN_GENOMES} x {MAIN_LEN} bp, k={K} w={W}; emissions per shard {[c for c, _ in counts]}')

    def run_step():
        _, _, checks = dist._step(shards, K, W, counts, e_hist, p_hist, devices)
        return checks

    def run_build():
        t0 = time.perf_counter()
        out = dist.build_distributed_arrays(records, offsets, targets, K, W, devices)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    samples = {name: dict(step_ms=[], build_s=[]) for name in variants}
    ref = None
    try:
        for rep in range(args.reps):
            for name in ('pfx', 'mask', 'mask', 'pfx'):
                dist._shard_step = variants[name]
                dist._check_step(run_step())
                step_ms = cuda_ms(run_step, iters=5)
                build_s, out = run_build()
                if ref is None:
                    ref = out
                elif not all(np.array_equal(a, b) for a, b in zip(out[:3], ref[:3])):
                    raise AssertionError(f'{name}: arrays differ from the first run')
                samples[name]['step_ms'].append(step_ms)
                samples[name]['build_s'].append(build_s)
                log(f'[ab] rep {rep} {name}: step {step_ms:.3f} ms, '
                    f'build_distributed_arrays {build_s:.4f} s')
    finally:
        dist._shard_step = variants['pfx']
    summary = {name: {key: dict(median=float(np.median(v)), min=float(np.min(v)),
                                max=float(np.max(v)), samples=v)
                      for key, v in s.items()} for name, s in samples.items()}
    log('[ab] both routes give the same arrays')
    log(card)
    print(json.dumps({'card': card, 'devices': [str(d) for d in devices], 'reps': args.reps,
                      'extract_ab': summary}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
