"""Input assembly registry + sequence fetch + BLAST database streaming.

Counterpart: `seqwin_tpu/assemblies.py`, without pandas: `Assemblies` is a
plain class holding the three columns (``path``, ``is_target``,
``record_ids``) as lists, and `get_assemblies` writes `assemblies.csv` with
the bytes `DataFrame.to_csv(columns=('path', 'is_target'), index=True)`
gives. Resolving inputs from taxa downloads / path lists / directories,
pairwise Mash distances, fetching marker sequences, and feeding
header-rewritten FASTAs to `makeblastdb`. Marker sequences are fetched in
threads of this process, which may hold a CUDA context: no fork.

The `makeblastdb` stream drains a sliding window of process-pool futures
strictly in submission order: a deterministic stdin byte stream with
bounded memory and no reorder buffer.
"""
from __future__ import annotations

import gzip
import logging
import re
import subprocess
from collections import deque
from collections.abc import Iterable, Iterator, Sequence
from concurrent.futures import Executor, Future, ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path
from time import time

import numpy as np
from numpy.typing import NDArray

from .config import BLASTCONFIG, WORKINGDIR, Config, RunState
from .io.fasta import load_fasta
from .mash import get_jaccard, sketch
from .ncbi import download_taxon
from .utils import (
    GZIP_EXT,
    claim_dir,
    claim_file,
    duplicates,
    fail,
    load_paths_txt,
    log_elapsed,
    write_csv,
)

logger = logging.getLogger(__name__)

_FASTA_EXT = (
    '.fna', '.fasta', '.fna.gz', '.fasta.gz',
    '.fa', '.fas', '.fa.gz', '.fas.gz',
)


def _windowed_ordered(
    executor: Executor, fn, jobs: Iterable[tuple], window: int
) -> Iterator:
    """Run ``fn(*job)`` on an executor, yielding results in job order while
    keeping at most ``window`` jobs in flight (bounded-memory pipeline)."""
    inflight: deque[Future] = deque()
    for job in jobs:
        inflight.append(executor.submit(fn, *job))
        if len(inflight) >= window:
            yield inflight.popleft().result()
    while inflight:
        yield inflight.popleft().result()


def fetch_threads(n_assemblies: int, n_cpu: int) -> int:
    """Threads `Assemblies.fetch_seq` loads ``n_assemblies`` FASTAs in."""
    return max(1, min(n_cpu, n_assemblies))


def _load_marker_seqs(path: Path, spans: list[tuple[int, int, int]]) -> list[str]:
    """Slice (record_idx, start, stop) spans out of one assembly."""
    records = load_fasta(path)
    return [records[rec][start:stop] for rec, start, stop in spans]


def _rewrite_fasta_headers(path: Path, assembly_idx: int, is_target: bool) -> bytes:
    """Worker: load one (possibly gzipped) FASTA and tag every header with
    `{assembly_idx}|{t/f}|` so BLAST hits map back to assemblies."""
    raw = path.read_bytes()
    if path.suffix == GZIP_EXT:
        raw = gzip.decompress(raw)
    tag = (
        f'>{assembly_idx}{BLASTCONFIG.header_sep}'
        f'{BLASTCONFIG.bool2str[is_target]}{BLASTCONFIG.header_sep}'
    ).encode()
    return re.sub(rb'^>', tag, raw, flags=re.MULTILINE)


class Assemblies:
    """All input assemblies, indexed 0..n-1 (targets first): ``path``,
    ``is_target`` and, once the graph is built, ``record_ids`` (per
    assembly, the tuple of its FASTA record ids)."""

    __slots__ = ('path', 'is_target', 'record_ids')

    def __init__(self, tar_paths: list[Path], neg_paths: list[Path]) -> None:
        self.path: list[Path] = list(tar_paths) + list(neg_paths)
        self.is_target: list[bool] = [True] * len(tar_paths) + [False] * len(neg_paths)
        self.record_ids: list[tuple[str, ...]] | None = None

    def __len__(self) -> int:
        return len(self.path)

    def to_csv(self, target: Path) -> None:
        """The index, path and is_target columns, as pandas writes them."""
        write_csv(target, ('', 'path', 'is_target'),
                  zip(range(len(self)), self.path, self.is_target))

    def mash(
        self, kmerlen: int, sketchsize: int, out_path: Path, overwrite: bool, n_cpu: int
    ) -> NDArray:
        """Pairwise Jaccard matrix via external mash."""
        msh = sketch(
            list(self.path), kmerlen=kmerlen, sketchsize=sketchsize,
            out_path=out_path, overwrite=overwrite, n_cpu=n_cpu,
        )
        n = len(self)
        return np.fromiter(get_jaccard(msh, n_cpu=n_cpu), dtype=np.float64).reshape(n, n)

    def fetch_seq(
        self, spans: Sequence[tuple[int, int, int, int]], n_cpu: int
    ) -> list[str]:
        """Sequences for (assembly_idx, record_idx, start, stop) spans,
        returned in span order; each assembly's FASTA is loaded once, in
        this process, in `fetch_threads` threads (file reads and gzip
        release the GIL)."""
        by_assembly: dict[int, list[tuple[int, int, int]]] = {}
        origin: dict[int, list[int]] = {}
        for row, (asm, rec, start, stop) in enumerate(spans):
            by_assembly.setdefault(asm, []).append((rec, start, stop))
            origin.setdefault(asm, []).append(row)
        logger.info(f' - {len(by_assembly)} assemblies to be loaded')

        paths = [self.path[asm] for asm in by_assembly]
        with ThreadPoolExecutor(max_workers=fetch_threads(len(paths), n_cpu)) as pool:
            per_assembly = list(pool.map(_load_marker_seqs, paths, by_assembly.values()))

        out: list[str] = [''] * len(spans)
        for asm, seqs in zip(by_assembly, per_assembly):
            for row, seq in zip(origin[asm], seqs):
                out[row] = seq
        return out

    def makeblastdb(self, prefix: Path, neg_only: bool, overwrite: bool, n_cpu: int) -> Path:
        """Build a BLAST database by streaming header-tagged FASTAs to stdin."""
        if neg_only:
            logger.info('Creating a BLAST database of non-target assemblies (less sensitive but faster)...')
            rows = [i for i, t in enumerate(self.is_target) if not t]
            title = BLASTCONFIG.title_neg_only
        else:
            logger.info('Creating a BLAST database of all assemblies...')
            rows = list(range(len(self)))
            title = BLASTCONFIG.title_all
        tik = time()

        claim_dir(prefix, overwrite)
        blastdb = prefix / title
        argv = ['makeblastdb', '-title', title, '-dbtype', 'nucl', '-out', str(blastdb)]
        proc = subprocess.Popen(
            argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        jobs = ((self.path[i], i, self.is_target[i]) for i in rows)
        with ProcessPoolExecutor(max_workers=n_cpu) as pool:
            for chunk in _windowed_ordered(
                pool, _rewrite_fasta_headers, jobs,
                window=BLASTCONFIG.queue_size + n_cpu,
            ):
                proc.stdin.write(chunk)
        stdout, stderr = proc.communicate()

        blast_log = prefix / WORKINGDIR.blast_log
        blast_log.write_text('\n'.join((str(argv), stdout.decode(), stderr.decode())))
        if proc.returncode != 0:
            fail(RuntimeError, f'Failed to create the BLAST database. For details, please check {blast_log}')
        logger.info(f' - BLAST database created: {blastdb}')
        log_elapsed(time() - tik)
        return blastdb


def _resolve_taxa(taxa: list[str], prefix: Path, config: Config) -> list[Path]:
    """Download every taxon's genome package; collect assembly paths."""
    found: list[Path] = []
    for taxon in taxa:
        paths = download_taxon(
            taxon=taxon, prefix=prefix, level=config.level, source=config.source,
            annotated=config.annotated, exclude_mag=config.exclude_mag, gzip=config.gzip,
            api_key=config.api_key.get_secret_value() if config.api_key is not None else None,
            overwrite=config.overwrite, n_cpu=config.n_cpu,
        )
        found.extend(paths or ())
    return found


def _resolve_txt(paths_txt: Path) -> list[Path]:
    found = load_paths_txt(paths_txt)
    logger.info(f'Found {len(found)} assemblies from {paths_txt}')
    return found


def _resolve_dir(input_dir: Path) -> list[Path]:
    found: list[Path] = []
    for entry in sorted(input_dir.iterdir(), key=lambda p: p.name):
        if entry.is_file() and entry.name.lower().endswith(_FASTA_EXT):
            found.append(entry.resolve(strict=True))
        elif entry.is_dir():
            logger.warning(f'- Skipped subdirectory {entry}')
        else:
            logger.warning(f'- Skipped unsupported file {entry}')
    logger.info(f'Found {len(found)} assemblies from {input_dir}')
    return found


def _require_unique(items: list, what: str) -> None:
    dups = duplicates(items)
    if dups:
        listing = '\n'.join(map(str, dups))
        fail(RuntimeError, f'{what}:\n{listing}')


def _download(config: Config, working_dir: Path) -> tuple[list[Path], list[Path]]:
    tar_taxa = config.tar_taxa or []
    neg_taxa = config.neg_taxa or []
    if not (tar_taxa or neg_taxa):
        return [], []
    _require_unique(tar_taxa + neg_taxa, 'Duplicated taxa')
    dl_prefix = working_dir / WORKINGDIR.assemblies_dir
    if dl_prefix.exists():
        logger.warning(
            f'Existing assemblies directory is found, genome packages might be reused: {dl_prefix}'
        )
    else:
        dl_prefix.mkdir()
    return (
        _resolve_taxa(tar_taxa, dl_prefix, config),
        _resolve_taxa(neg_taxa, dl_prefix, config),
    )


def get_assemblies(config: Config, state: RunState) -> Assemblies:
    """Resolve all inputs (download / txt / dir), dedup, save assemblies.csv."""
    working_dir = state.working_dir
    tar_paths, neg_paths = _download(config, working_dir)

    if not config.download_only:
        for paths, txt, directory in (
            (tar_paths, config.tar_paths, config.tar_dir),
            (neg_paths, config.neg_paths, config.neg_dir),
        ):
            if txt is not None:
                paths.extend(_resolve_txt(txt))
            if directory is not None:
                paths.extend(_resolve_dir(directory))
        if not tar_paths:
            fail(RuntimeError, 'No target assembly found')
        if not neg_paths:
            fail(RuntimeError, 'No non-target assembly found')
        _require_unique(tar_paths + neg_paths, 'Duplicated assembly file paths')

    assemblies = Assemblies(tar_paths, neg_paths)
    state.n_tar, state.n_neg = len(tar_paths), len(neg_paths)
    logger.info(
        f'Loaded {state.n_tar} target assemblies and {state.n_neg} non-target assemblies, '
        f'{len(assemblies)} in total.'
    )

    csv_path = working_dir / WORKINGDIR.assemblies_csv
    claim_file(csv_path, config.overwrite)
    assemblies.to_csv(csv_path)
    logger.info(f'Assembly indices and paths saved as {csv_path}')
    return assemblies
