"""The control of the comparison: the reference put in the program's place,
with penalties and the threshold computed in float32, the precision below
the float64 the configuration states. `compare` must find it wrong.

    python3 portbench/control.py --workload <name> --seeds 11 12 13

runs at the cell's own size on the card (the benchmark's runs never run
it) and prints, for each seed, every comparison number beside its limit and
whether the control failed, and a last line of JSON with all readings.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

if __package__ in (None, ''):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import compare, spec  # noqa: E402
from portbench.reference import pipeline  # noqa: E402


def readings(cell_name: str, seed: int, device, bench: dict | None = None, n_cpu: int = 8) -> dict:
    """The comparison numbers of the control against the reference on the
    cell's data for ``seed``."""
    cell = spec.cell(spec.benchmark() if bench is None else bench, cell_name)
    config = cell['config']
    work = Path(tempfile.mkdtemp(prefix='portbench-control-'))
    try:
        gen = spec.module('datagen', config['generator'])
        data = gen.generate(work, seed, **config['generator_params'])
        args = (data['paths'], data['is_target'], config['kmerlen'], config['windowsize'],
                cell['traffic']['argv'], device)
        want = pipeline.run(*args, n_cpu=n_cpu)
        got = pipeline.run(*args, penalty_dtype=np.float32, n_cpu=n_cpu)
        return compare.compare(want, got)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog='portbench/control.py')
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    out = {}
    for seed in args.seeds:
        numbers = readings(args.workload, seed, args.device)
        out[seed] = numbers
        shown = ', '.join(f'{n} {v} (limit {compare.LIMITS[n]})' for n, v in numbers.items())
        print(f'control {args.workload} seed {seed}: {shown}; '
              f'{"failed" if not compare.passes(numbers) else "PASSED"}', flush=True)
    print(json.dumps({'workload': args.workload, 'readings': out}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
