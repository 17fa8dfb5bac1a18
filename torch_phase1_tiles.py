#!/usr/bin/env python3
"""Time of the phase-1 kernels against their tile, on one CUDA GPU.

Run from the repository root on a machine with an H100 and nvcc:

    python3 torch_phase1_tiles.py [--seed 0] [--tiles 2048 4096 8192]

`csrc/phase1.cu` runs one CTA per tile of output positions
(`engine.phase1._TILE`). For each tile given, in that order and then
reversed, this script sets the tile, times kernels B1 `phase1_z`, B2
`phase1_zc` and B3 `phase1_pfx` with CUDA events (20 launches after
warm-up) on one 2^25-position stream at k=21, w=200 (`chip_smoke.py`'s
chunk model), and checks every output against the plain version at that
tile. It restores the tile, prints the card's name and power limit, and
ends with one JSON line of the times.
"""
from __future__ import annotations

import argparse
import json
import sys

from chip_smoke import K, W, chunk_stream, cuda_ms, log, smi


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--tiles', type=int, nargs='+', default=[2048, 4096, 8192])
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print('torch_phase1_tiles: no CUDA device available', file=sys.stderr)
        return 1
    from seqwin_tpu_torch.engine import phase1

    codes = torch.from_numpy(chunk_stream(args.seed)).cuda()
    modes = {
        'phase1_z': (lambda: (phase1.phase1_z(codes, K, W),),
                     lambda: (phase1.phase1_z_plain(codes, K, W),)),
        'phase1_zc': (lambda: phase1.phase1_zc(codes, K, W),
                      lambda: phase1.phase1_zc_plain(codes, K, W)),
        'phase1_pfx': (lambda: phase1.phase1_pfx(codes, K, W)[:2],
                       lambda: phase1.pfx_from_z(phase1.phase1_z_plain(codes, K, W), phase1._TILE)),
    }
    default = phase1._TILE
    times = {}
    try:
        for tile in args.tiles + args.tiles[::-1]:
            phase1._TILE = tile
            for name, (fn, plain) in modes.items():
                bad = sum(int((a != b).sum()) for a, b in zip(fn(), plain()))
                if bad:
                    raise AssertionError(f'{name} at tile {tile}: {bad} mismatches')
                ms = cuda_ms(fn, iters=20)
                times.setdefault(name, {}).setdefault(tile, []).append(ms)
                log(f'[tiles] {name} tile={tile} n={codes.numel()} k={K} w={W}: '
                    f'{ms:.4f} ms, mismatches=0')
    finally:
        phase1._TILE = default
    log(smi())
    print(json.dumps({'tiles': times, 'default_tile': default}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
