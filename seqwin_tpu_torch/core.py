"""Run orchestration: the `Seqwin` instance, `run()` and `load()` entry points.

Counterpart: `seqwin_tpu/core.py`. Keeps the reference's on-disk run
protocol: working-directory overwrite semantics, `config.json` dump, the
`--no-filter` -> `graph.npz` escape hatch, and a whole-instance pickle
(`results.seqwin`) that `load()` round-trips. The pickle holds numpy arrays
and Python objects only (no tensor, no device graph), so it loads in a
process without a GPU. With ``Config.profile_dir`` the run is traced with
`torch.profiler`.
"""
from __future__ import annotations

import logging
import pickle
from contextlib import contextmanager
from pathlib import Path
from random import Random

import numpy as np
from numpy.typing import NDArray

from .assemblies import Assemblies, get_assemblies
from .config import WORKINGDIR, Config, RunState, config_logger
from .device import resolve_device
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


@contextmanager
def _maybe_profile(profile_dir: Path | None):
    """Trace the run with `torch.profiler` when `Config.profile_dir` is set:
    `trace.json` (Chrome trace format) lands in that directory, and the log
    gets the device-busy total (kernels and copies)."""
    if profile_dir is None:
        yield
        return
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    profile_dir.mkdir(parents=True, exist_ok=True)
    logger.info(f'torch.profiler trace -> {profile_dir}')
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        trace = profile_dir / 'trace.json'
        prof.export_chrome_trace(str(trace))
        busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type != DeviceType.CPU
                      and not getattr(e, 'is_user_annotation', False))
        logger.info(f' - Device busy {busy_us / 1e3:.3f} ms; trace saved as {trace}')


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
        claim_file(target, self.config.overwrite)
        target.write_bytes(pickle.dumps(self))
        logger.info(f'Run instance (includes all run data) saved as {target}')


def run(config: Config) -> Seqwin:
    """Run the full pipeline for a config. Without ``config.device`` the run
    needs a GPU, and fails before writing anything when there is none; the
    host builds (``device_backend='numpy'|'oracle'``) need no device."""
    if not config.download_only and config.device_backend not in ('numpy', 'oracle'):
        resolve_device(config.device)
    seqwin = Seqwin(config)
    if not config.download_only:
        seqwin.run()
    return seqwin


def load(path: str | Path) -> Seqwin:
    """Load a pickled run instance (results.seqwin)."""
    return pickle.loads(Path(path).read_bytes())
