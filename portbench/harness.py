"""One run of one cell: set-up, the measured window, the comparison with the
reference, and the result line.

Set-up makes the cell's FASTAs from the seed under ``TMPDIR``, imports the
port (whose kernel and ingest builds are cached inside the checkout, so
only a checkout's first run builds them) and runs one whole warm-up job.
The window then starts jobs back to back, each `seqwin_tpu_torch.cli.main`
with the cell's options and a fresh ``--title``, until ``--seconds`` have
passed, and lets the job in flight finish. After the window every job's
outputs are compared with the reference's (`compare.py`), worked out from
the same FASTAs once the program's memory is freed.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from . import compare, outputs, spec
from .phases import phase_seconds
from .trace import JOB_SPAN, Job, Run, device_busy_us, from_profiler, idle_gaps, top_device_ops

FORBIDDEN = frozenset(('jax', 'jaxlib', 'flax', 'seqwin_tpu'))
REFERENCE_CPUS = 8


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split('.')[0] for name in list(sys.modules)} & FORBIDDEN)


class Cuda:
    """The card the run measures."""

    platform = 'gpu'
    torch_device = 'cuda'

    def __init__(self):
        import torch
        self.torch = torch

    def missing(self, chips: int) -> str | None:
        cuda = self.torch.cuda
        if not cuda.is_available():
            return 'torch.cuda.is_available() is false'
        if cuda.device_count() < chips:
            return f'the cell needs {chips} cards and {cuda.device_count()} are present'
        return None

    def kind(self) -> str:
        return self.torch.cuda.get_device_name(0)

    def power_limit(self) -> str:
        try:
            res = subprocess.run(['nvidia-smi', '--query-gpu=power.limit', '--format=csv,noheader'],
                                 capture_output=True, text=True, timeout=30)
            return res.stdout.strip().splitlines()[0]
        except (OSError, subprocess.SubprocessError, IndexError):
            return 'unknown'

    def sync(self) -> None:
        self.torch.cuda.synchronize()

    def reset_peak(self) -> None:
        self.torch.cuda.reset_peak_memory_stats()

    def peak(self) -> int:
        return self.torch.cuda.max_memory_allocated()

    def free(self) -> None:
        gc.collect()
        self.torch.cuda.empty_cache()

    def activities(self) -> list:
        from torch.profiler import ProfilerActivity
        return [ProfilerActivity.CPU, ProfilerActivity.CUDA]


class _Marks(logging.Handler):
    """(level, message, host clock) of every record the program logs: the
    phases' host spans, which name the idle gaps of a traced run."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.marks: list = []

    def emit(self, record):
        self.marks.append((record.levelname, record.getMessage(), time.perf_counter()))


class Jobs:
    """Runs CLI jobs in this process and keeps what each left behind."""

    def __init__(self, work: Path, lists: dict, config: dict, traffic: dict):
        from seqwin_tpu_torch import cli
        from seqwin_tpu_torch.engine import phase1, timeline

        self.cli, self.phase1, self.timeline = cli, phase1, timeline
        self.dir = work / 'jobs'
        self.dir.mkdir()
        self.argv = ['--tar-paths', str(lists['tar']), '--neg-paths', str(lists['neg']),
                     '--prefix', str(self.dir), '-k', str(config['kmerlen']),
                     '-w', str(config['windowsize']), *traffic['argv']]
        self.records: list[Job] = []
        self.failed = 0

    def run(self, title: str, traced: bool = False) -> Job:
        """One job; ``traced`` wraps it in a `JOB_SPAN` span and stamps its
        log records."""
        from torch.profiler import record_function

        root = logging.getLogger()
        before = list(root.handlers)
        marks = _Marks() if traced else None
        if marks is not None:
            root.addHandler(marks)
        launches = self.phase1.phase1_z.launches
        t0 = time.perf_counter()
        try:
            with record_function(JOB_SPAN) if traced else contextlib.nullcontext():
                rc = self.cli.main([*self.argv, '--title', title])
        except Exception as e:  # a job that raises is a failed job
            print(f'portbench: job {title} raised {type(e).__name__}: {e}', file=sys.stderr)
            rc = -1
        wall = time.perf_counter() - t0
        for h in list(root.handlers):
            if h not in before:
                root.removeHandler(h)
                h.close()
        self.timeline.drain()
        if rc != 0:
            self.failed += 1
        log = self.dir / title / 'seqwin.log'
        return Job(wall_s=wall, start_s=t0, log_marks=marks.marks if marks is not None else [],
                   phases=phase_seconds(log.read_text()) if log.is_file() else {},
                   counters={'b1_launches': self.phase1.phase1_z.launches - launches})


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog='portbench/run.py')
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _window(jobs: Jobs, dev, seconds: float, traced: bool):
    """Jobs back to back for ``seconds`` (the last one finishes); returns
    (window seconds, profiler or None)."""
    prof = None
    if traced:
        from torch.profiler import profile
        prof = profile(activities=dev.activities())
        prof.start()
    dev.sync()
    t0 = time.perf_counter()
    while True:
        gc.collect()  # the last job's garbage, as a fresh process would start
        jobs.records.append(jobs.run(f'job{len(jobs.records):03d}', traced=traced))
        if time.perf_counter() - t0 >= seconds:
            break
    dev.sync()
    window_s = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
        print(f'portbench: the profiler stopped in {time.perf_counter() - t0 - window_s:.3f} s',
              file=sys.stderr)
    return window_s, prof


def _judge(jobs: Jobs, want) -> tuple[list[dict], dict]:
    """Every job's comparison numbers (jobs with equal outputs compared
    once), and the most rows any job got wrong in each layer."""
    seen: list[tuple] = []  # (outputs, numbers)
    readings, by_layer = [], {}
    for i in range(len(jobs.records)):
        got = outputs.read(jobs.dir / f'job{i:03d}')
        shutil.rmtree(jobs.dir / f'job{i:03d}', ignore_errors=True)
        numbers = next((n for o, n in seen if not any(compare.compare(o, got).values())), None)
        if numbers is None:
            numbers = compare.compare(want, got)
            seen.append((got, numbers))
            for name, rows in compare.layers(want, got).items():
                by_layer[name] = max(rows, by_layer.get(name, 0))
        readings.append(numbers)
    return readings, by_layer


def main(argv=None, t_start: float | None = None, bench: dict | None = None, dev=None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    bench = spec.benchmark() if bench is None else bench
    cell = spec.cell(bench, args.workload)
    config, traffic = cell['config'], cell['traffic']
    if importlib.util.find_spec('seqwin_tpu_torch') is None:
        print('portbench: the program, seqwin_tpu_torch, is not in this checkout; no result',
              file=sys.stderr)
        return 5
    dev = Cuda() if dev is None else dev
    problem = dev.missing(cell['chips'])
    if problem:
        print(f'portbench: {problem}; no result', file=sys.stderr)
        return 3
    if args.trace:
        os.environ['SEQWIN_TPU_TORCH_TIMELINE'] = '1'

    work = Path(tempfile.mkdtemp(prefix='portbench-'))
    try:
        gen = spec.module('datagen', config['generator'])
        data = gen.generate(work / 'fasta', args.seed % (1 << 64), **config['generator_params'])
        lists = {}
        for key, want in (('tar', True), ('neg', False)):
            lists[key] = work / f'{key}_paths.txt'
            lists[key].write_text(''.join(f'{p}\n' for p, t in zip(data['paths'], data['is_target'])
                                          if t == want))
        t_data = time.perf_counter()
        jobs = Jobs(work, lists, config, traffic)
        t_import = time.perf_counter()
        jobs.run('warmup')
        shutil.rmtree(jobs.dir / 'warmup', ignore_errors=True)
        jobs.failed = 0
        gc.collect()
        gc.freeze()  # set-up's objects: the collections between jobs skip them
        dev.sync()
        setup_s = time.perf_counter() - t_start
        print(f'portbench: set-up {setup_s:.3f} s: FASTAs {t_data - t_start:.3f}, import '
              f'{t_import - t_data:.3f}, warm-up job {t_start + setup_s - t_import:.3f}',
              file=sys.stderr)

        setup_peak = dev.peak()
        dev.reset_peak()
        window_s, prof = _window(jobs, dev, args.seconds, args.trace == 1)
        peak = dev.peak()
        run = Run(jobs=jobs.records, window_s=window_s, positions=sum(data['record_lengths']),
                  setup_s=setup_s, peak_bytes=peak)
        if prof is not None:
            t0 = time.perf_counter()
            run.events = from_profiler(prof)
            del prof
            print(f'portbench: the trace: {len(run.events)} events kept, read in '
                  f'{time.perf_counter() - t0:.3f} s', file=sys.stderr)
            first = next((e for e in run.events if not e.device and e.name == JOB_SPAN), None)
            if first is not None:
                run.clock_offset_us = first.start_us - jobs.records[0].start_s * 1e6
        found = forbidden_modules()
        if found:
            print(f'portbench: the run loaded {found}; no result', file=sys.stderr)
            return 4

        dev.free()
        try:
            from .reference import pipeline
            want = pipeline.run(data['paths'], data['is_target'], config['kmerlen'],
                                config['windowsize'], traffic['argv'], dev.torch_device,
                                n_cpu=REFERENCE_CPUS)
            readings, by_layer = _judge(jobs, want)
        except Exception as e:
            print(f'portbench: the comparison failed: {type(e).__name__}: {e}', file=sys.stderr)
            readings, by_layer = [], {}
        numbers = compare.worst(readings)
        correct = bool(readings) and jobs.failed == 0 and compare.passes(numbers)

        kind = 'per_layer' if args.trace else 'end_to_end'
        metrics = {}
        for m in spec.metrics(bench, args.workload, kind):
            value = spec.module(kind if kind == 'end_to_end' else 'metrics', m['name']).read(run)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
        device = {'platform': dev.platform, 'kind': dev.kind(), 'count': cell['chips'],
                  'memory_peak_bytes': max(peak, setup_peak),
                  'power_limit': dev.power_limit()}
        result = {'correct': correct, 'attempted': len(jobs.records), 'failed': jobs.failed,
                  'metrics': metrics, 'device': device}
        if args.trace:
            device['busy_s'] = device_busy_us(run.events) / 1e6
            device['window_s'] = window_s
            result['breakdown'] = {'device_ops': top_device_ops(run.events),
                                   'idle_gaps': idle_gaps(run)}
        result['compared'] = {n: {'value': numbers.get(n), 'limit': lim}
                              for n, lim in compare.LIMITS.items()}
        found = forbidden_modules()
        if found:
            print(f'portbench: the run loaded {found}; no result', file=sys.stderr)
            return 4
        walls = ' '.join(f'{j.wall_s:.3f}' for j in jobs.records)
        print(f'portbench: {args.workload} seed {args.seed}: job walls (s) {walls}; '
              f'{len(readings)} jobs compared; rows differing by layer {by_layer}', file=sys.stderr)
        for n, lim in compare.LIMITS.items():
            print(f'compared {n} {numbers.get(n)} limit {lim}', file=sys.stderr)
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
        return 0
    finally:
        shutil.rmtree(work, ignore_errors=True)
