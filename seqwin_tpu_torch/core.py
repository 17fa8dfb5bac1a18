"""Run orchestration: the `Seqwin` instance, `run()` and `load()` entry points.

Counterpart: `seqwin_tpu/core.py`. Keeps the reference's on-disk run
protocol: working-directory overwrite semantics, `config.json` dump, the
`--no-filter` -> `graph.npz` escape hatch, and a whole-instance pickle
(`results.seqwin`) that `load()` round-trips. The pickle holds numpy arrays
and Python objects only (no tensor, no device graph), so it loads in a
process without a GPU. A run is span ``run`` of the recorder
(`engine/timeline.py`), with ``run.assemblies`` and ``run.save_results``
inside. With ``Config.profile_dir`` the run is traced with `torch.profiler`
and the recorder on.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import pickle
from contextlib import contextmanager
from pathlib import Path
from random import Random

import numpy as np
from numpy.typing import NDArray

from .assemblies import Assemblies, get_assemblies
from .config import WORKINGDIR, Config, RunState, config_logger
from .device import resolve_device
from .engine import timeline
from .pipeline.kmers import KmerGraph, get_kmers
from .pipeline.markers import ConnectedKmers, get_markers
from .utils import claim_dir, claim_file

logger = logging.getLogger(__name__)


def _open_working_dir(config: Config) -> Path:
    """Create (or, with --overwrite, reuse in place) the run directory and
    attach the per-run log file."""
    working_dir = config.prefix / config.title
    existed = working_dir.is_dir()
    claim_dir(working_dir, overwrite=config.overwrite, verbose=True, wipe=False)
    if not existed:
        logger.info(f'Created output directory {working_dir}')

    config_logger(working_dir / WORKINGDIR.log, logging.INFO)
    logger.info(f'Running seqwin-tpu-torch v{config.version}')
    if config.n_cpu == 1:
        logger.warning('Using only one CPU thread, longer running time is expected')
    return working_dir


def _save_config(config: Config, working_dir: Path) -> None:
    target = working_dir / WORKINGDIR.config
    claim_file(target, config.overwrite)
    target.write_text(config.model_dump_json(indent=4))
    logger.info(f'Run configurations saved as {target}')


def _save_raw_graph(kmers: KmerGraph, config: Config, working_dir: Path) -> None:
    target = working_dir / WORKINGDIR.graph
    claim_file(target, config.overwrite)
    np.savez(
        target,
        kmers=kmers.kmers,
        nodes=kmers.nodes,
        edges=kmers.edges,
        record_offsets=kmers.record_offsets,
    )
    logger.info(f'Filtering is turned off. Raw minimizer graph is saved as {target}')


def _device_busy_us(prof) -> float:
    """The union of a stopped profiler's device intervals (kernels, copies,
    sets), in us: work overlapping on several streams counts once. The
    profiler's own rows and the device-side mirrors of host spans are no
    work."""
    from torch.autograd import DeviceType

    raw = prof.profiler.kineto_results.events()
    spans = {e.name() for e in raw if e.device_type() == DeviceType.CPU and e.is_user_annotation()}
    busy, end = 0, None
    for s, e in sorted((e.start_ns(), e.end_ns()) for e in raw
                       if e.device_type() != DeviceType.CPU and not e.is_user_annotation()
                       and e.name() not in spans and e.name() != 'Activity Buffer Request'):
        if end is None or s > end:
            busy, end = busy + e - s, e
        elif e > end:
            busy, end = busy + e - end, e
    return busy / 1e3


def _add_unseen_spans(trace: Path, spans) -> int:
    """Append to ``trace`` (a Chrome trace the profiler exported) the
    recorded spans of the threads it holds no event of (the parse and prep
    pools' threads, which torch.profiler does not see), one row per thread,
    on the file's own time base. Returns the number added."""
    doc = json.loads(trace.read_text())
    events = doc['traceEvents']
    pid = os.getpid()
    seen = {e.get('tid') for e in events if e.get('pid') == pid and e.get('ph') == 'X'}
    base = doc.get('baseTimeNanoseconds', 0)
    extra = [s for s in spans if s.thread not in seen]
    for tid in sorted({s.thread for s in extra}):
        events.append({'ph': 'M', 'name': 'thread_name', 'pid': pid, 'tid': tid,
                       'args': {'name': f'thread {tid} (seqwin spans)'}})
    for s in extra:
        events.append({'ph': 'X', 'cat': 'seqwin_span', 'name': s.name, 'pid': pid,
                       'tid': s.thread, 'ts': (s.start_ns - base) / 1e3,
                       'dur': (s.end_ns - s.start_ns) / 1e3,
                       'args': {**s.attrs, 'span': s.id, 'parent': s.parent}})
    trace.write_text(json.dumps(doc, default=str))
    return len(extra)


@contextmanager
def _maybe_profile(profile_dir: Path | None):
    """Trace the run with `torch.profiler` when `Config.profile_dir` is set,
    with the span recorder on: `trace.json` (Chrome trace format) lands in
    that directory with the recorder's spans of the threads the profiler
    does not see added, and the log gets the device busy (the union of
    kernel, copy and set intervals)."""
    if profile_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    profile_dir.mkdir(parents=True, exist_ok=True)
    logger.info(f'torch.profiler trace -> {profile_dir}')
    with timeline.recording():
        n_before = len(timeline.spans())
        prof = profile(activities=activities)
        prof.start()
        try:
            yield
        finally:
            prof.stop()
            trace = profile_dir / 'trace.json'
            busy_us = _device_busy_us(prof)
            prof.export_chrome_trace(str(trace))
            added = _add_unseen_spans(trace, timeline.spans()[n_before:])
            logger.info(f' - Device busy {busy_us / 1e3:.3f} ms; trace saved as {trace} '
                        f'({added} spans of pool threads added)')


class Seqwin:
    """One pipeline run: config -> assemblies -> k-mer graph -> signatures."""

    __slots__ = ('config', 'state', 'assemblies', 'kmers', 'mash', 'markers')

    config: Config
    state: RunState
    assemblies: Assemblies
    kmers: KmerGraph | None
    mash: NDArray | None
    markers: list[ConnectedKmers] | None

    def __init__(self, config: Config) -> None:
        working_dir = _open_working_dir(config)
        _save_config(config, working_dir)

        self.config = config
        self.state = RunState(working_dir=working_dir, rng=Random(config.seed))
        with timeline.span('run.assemblies'):
            self.assemblies = get_assemblies(config, self.state)
        self.kmers = None
        self.mash = None
        self.markers = None

    def run(self) -> None:
        """Build the k-mer graph and extract candidate markers."""
        config = self.config
        with _maybe_profile(config.profile_dir):
            kmers, jaccard = get_kmers(self.assemblies, config, self.state)
            if config.no_filter:
                _save_raw_graph(kmers, config, self.state.working_dir)
                return
            self.kmers = kmers
            self.mash = jaccard
            self.markers = get_markers(kmers, self.assemblies, config, self.state)
            self._save_results()

    def _save_results(self) -> None:
        target = self.state.working_dir / WORKINGDIR.results
        with timeline.span('run.save_results') as s:
            claim_file(target, self.config.overwrite)
            data = pickle.dumps(self)
            target.write_bytes(data)
            s.set(bytes=len(data))
        logger.info(f'Run instance (includes all run data) saved as {target}')


def run(config: Config) -> Seqwin:
    """Run the full pipeline for a config. Without ``config.device`` the run
    needs a GPU, and fails before writing anything when there is none; the
    host builds (``device_backend='numpy'|'oracle'``) need no device.
    Re-reads the recorder's gate (`engine.timeline.gate`) when it starts;
    ``config.profile_dir`` switches the recorder on for the run."""
    profiled = config.profile_dir is not None and not config.download_only
    with timeline.recording() if profiled else contextlib.nullcontext():
        timeline.gate()
        with timeline.span('run', title=config.title):
            if not config.download_only and config.device_backend not in ('numpy', 'oracle'):
                resolve_device(config.device)
            seqwin = Seqwin(config)
            if not config.download_only:
                seqwin.run()
    return seqwin


def load(path: str | Path) -> Seqwin:
    """Load a pickled run instance (results.seqwin)."""
    return pickle.loads(Path(path).read_bytes())
