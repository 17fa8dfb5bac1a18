"""Host-side plumbing: failure logging, the filesystem overwrite protocol,
subprocess execution, and order-preserving process pools.

Counterpart: `seqwin_tpu/utils.py` (a copy, plus `write_csv`, which stands
in for pandas' CSV writer). Three primitives:

- ``fail``      -- log at CRITICAL, then raise (optionally chained);
- ``claim_*``   -- the overwrite protocol: a path is *claimed* before writing,
                   and an existing path is either wiped (``overwrite``) or
                   refused with ``FileExistsError``;
- ``pool_map``  -- deterministic, order-preserving multiprocess fan-out.

``pool_map`` forks: by the time the pipeline calls it (BLAST's metrics
only) the parent may hold a CUDA context, so the functions it runs touch
numpy and the standard library only, never torch. A pool's life is three spans of the recorder
(`engine/timeline.py`): ``pool.start`` (the fork), ``pool.map`` and
``pool.stop`` (the workers ended and reaped; ``child_cpu_s``, their user
and system CPU seconds, taken only while the recorder is on).
"""
from __future__ import annotations

import csv
import datetime
import logging
import multiprocessing
import resource
import shlex
import shutil
import subprocess
import sys
from collections import Counter
from collections.abc import Callable, Hashable, Iterable
from pathlib import Path
from time import time
from typing import Literal, NoReturn

from .engine import timeline

logger = logging.getLogger(__name__)

GZIP_EXT = '.gz'

#: sentinel: "leave exception chaining alone" (distinct from ``cause=None``,
#: which suppresses the chain like ``raise ... from None``)
_CHAIN = object()


def fail(
    exc: type[Exception] = Exception,
    msg: str = '',
    cause: BaseException | None | object = _CHAIN,
) -> NoReturn:
    """Log ``msg`` at CRITICAL and raise ``exc(msg)``.

    ``cause=None`` suppresses exception chaining; an exception instance sets
    ``__cause__``; the default keeps whatever context is active.
    """
    logger.critical(msg if msg else exc.__name__)
    if cause is _CHAIN:
        raise exc(msg)
    raise exc(msg) from cause  # type: ignore[misc]


def log_elapsed(seconds: float) -> None:
    """Phase timer line (same format as the reference run logs)."""
    logger.info(f' - Finished in {datetime.timedelta(seconds=seconds)}')


def read_text(path: Path) -> str:
    """UTF-8 text with universal newline normalization."""
    with open(path, 'r', encoding='utf-8', newline=None) as f:
        return f.read()


def _refuse_existing(path: Path) -> NoReturn:
    fail(
        FileExistsError,
        f'File/directory already exists, and overwriting is turned off: {path}',
        cause=None,
    )


def warn_overwrite(path: Path) -> None:
    logger.warning(
        'File/directory already exists, content is overwritten '
        f'(overwriting is turned on): {path}'
    )


def claim_dir(
    path: Path, overwrite: bool = False, verbose: bool = False, wipe: bool = True
) -> None:
    """Claim ``path`` as a directory, creating it if needed.

    An existing directory is an error unless ``overwrite`` is set; with
    ``overwrite`` it is emptied (``wipe=True``) or reused in place
    (``wipe=False`` -- the working-directory pattern, where individual files
    are re-claimed one by one).
    """
    if path.is_dir():
        if not overwrite:
            _refuse_existing(path)
        if verbose:
            warn_overwrite(path)
        if wipe:
            shutil.rmtree(path)
            path.mkdir(parents=False)
    elif path.exists():
        fail(
            NotADirectoryError,
            f'Cannot create directory, since it already exists as a file: {path}',
        )
    else:
        path.mkdir(parents=False)


def claim_file(path: Path, overwrite: bool = False, verbose: bool = False) -> None:
    """Claim ``path`` for a file write: remove an existing file (``overwrite``)
    or refuse; a directory at ``path`` is always an error."""
    if path.is_dir():
        fail(IsADirectoryError, f'Expected a file, but a directory is found: {path}')
    if path.is_file():
        if not overwrite:
            _refuse_existing(path)
        if verbose:
            warn_overwrite(path)
        path.unlink()


def list_dir(path: Path = Path.cwd(), mode: Literal['a', 'd', 'f'] = 'a') -> list[Path]:
    """Children of ``path`` sorted by name; 'd' = dirs only, 'f' = files only."""
    if not path.is_dir():
        fail(NotADirectoryError, f'Not a directory: {path}')
    predicates: dict[str, Callable[[Path], bool]] = {
        'a': lambda p: True,
        'd': Path.is_dir,
        'f': Path.is_file,
    }
    keep = predicates.get(mode)
    if keep is None:
        fail(ValueError, f'Invalid mode for list_dir: {mode}')
    return sorted((p for p in path.iterdir() if keep(p)), key=lambda p: p.name)


def run_tool(
    *argv: str | Path, stdin: str | None = None, check: bool = True
) -> subprocess.CompletedProcess:
    """Run an external tool, capturing text output.

    On non-zero exit with ``check``, the failure (command line, exit code,
    stderr) is logged and re-raised as ``RuntimeError``.
    """
    bad = [a for a in argv if not isinstance(a, (str, Path))]
    if bad:
        fail(TypeError, 'Only str or Path are accepted as command line arguments')
    try:
        return subprocess.run(
            argv, input=stdin, capture_output=True, text=True, check=check
        )
    except subprocess.CalledProcessError as e:
        lines = [
            'Subprocess failed',
            f'cmd: {shlex.join(str(c) for c in e.cmd)}',
            f'exit code: {e.returncode}',
            f'stderr:\n{(e.stderr or "").strip()}',
        ]
        fail(RuntimeError, '\n'.join(lines), cause=e)


def _pool_context() -> multiprocessing.context.BaseContext:
    # fork on POSIX (cheap, inherits loaded data), spawn where fork is unsafe
    return multiprocessing.get_context('spawn' if sys.platform == 'win32' else 'fork')


def pool_map(
    fn: Callable,
    jobs: Iterable,
    processes: int = 1,
    star: bool = True,
    label: str | None = None,
    total: int | None = None,
) -> list:
    """Map ``fn`` over ``jobs`` with an optional process pool.

    Results always come back in job order. ``total`` (when the job count is
    known) sizes pool chunks as ceil(total / 4*processes), matching stdlib
    heuristics without materializing ``jobs``.
    """
    t0 = time()
    if label:
        logger.info(f'{label} (processes={processes})')
    if processes < 1:
        fail(ValueError, 'n_cpu should be an positive integer')
    if processes == 1:
        with timeline.span('pool.map', processes=1, jobs=total):
            out = [fn(*j) for j in jobs] if star else [fn(j) for j in jobs]
    else:
        chunksize = None if total is None else -(-total // (4 * processes)) or 1
        cpu0 = _children_cpu_s() if timeline.enabled() else None
        with timeline.span('pool.start', processes=processes):
            pool = _pool_context().Pool(processes=processes)
        try:
            with timeline.span('pool.map', processes=processes, jobs=total, chunksize=chunksize):
                out = (pool.starmap if star else pool.map)(fn, jobs, chunksize=chunksize)
        finally:
            with timeline.span('pool.stop') as s:
                pool.terminate()  # what `with Pool()` does on exit; joins the workers
                if s and cpu0 is not None:
                    s.set(child_cpu_s=_children_cpu_s() - cpu0)
    if label:
        log_elapsed(time() - t0)
    return out


def _children_cpu_s() -> float:
    """User plus system CPU seconds of this process's reaped children."""
    ru = resource.getrusage(resource.RUSAGE_CHILDREN)
    return ru.ru_utime + ru.ru_stime


def write_csv(path: Path, header: Iterable[str], rows: Iterable[Iterable]) -> None:
    """The bytes `pandas.DataFrame.to_csv` writes for these rows (the port's
    own; the JAX package writes with pandas): minimal quoting, ``\\n`` line
    ends, None as an empty field, numbers and bools as ``str`` gives them
    (the shortest round-trip repr for floats)."""
    with open(path, 'w', encoding='utf-8', newline='') as f:
        writer = csv.writer(f, lineterminator='\n', quoting=csv.QUOTE_MINIMAL)
        writer.writerow(header)
        writer.writerows(rows)


def duplicates(items: Iterable[Hashable]) -> set:
    """Set of elements appearing more than once."""
    return {x for x, n in Counter(items).items() if n > 1}


def load_paths_txt(paths_txt: Path) -> list[Path]:
    """One path per line; relative entries resolve against the txt's directory.

    Missing files and directories are logged and skipped (the reference's
    lenient input-list semantics).
    """
    paths_txt = paths_txt.resolve(strict=True)
    found: list[Path] = []
    for raw in paths_txt.read_text().splitlines():
        entry = raw.strip()
        if not entry:
            continue
        candidate = Path(entry)
        if not candidate.is_absolute():
            candidate = paths_txt.parent / candidate
        if candidate.is_file():
            found.append(candidate.resolve(strict=True))
        elif candidate.is_dir():
            logger.error(f' - This is a directory, skipped: {candidate}')
        else:
            logger.error(f' - File not found, skipped: {candidate}')
    return found
