"""Assembly distance estimation with the external `mash` tool.

Counterpart: the subprocess half of `seqwin_tpu/mash.py` (`sketch`, `dist`,
`get_jaccard`), with the `mash dist` table parsed without pandas. The
device MinHash sketches of the JAX package are ROADMAP A12.
"""
from __future__ import annotations

import logging
import subprocess
from collections.abc import Generator, Iterable
from pathlib import Path

import numpy as np

from .ncbi import Table, read_tsv
from .utils import claim_file, fail, run_tool

logger = logging.getLogger(__name__)

_MASH_SKETCH_EXT = '.msh'
_STDIN = Path('/dev/stdin')


def sketch(
    assembly_path: Path | Iterable[Path],
    kmerlen: int = 21,
    sketchsize: int = 1000,
    out_path: Path | None = None,
    overwrite: bool = False,
    n_cpu: int = 1,
) -> Path:
    """`mash sketch` one or many assemblies into a merged .msh file."""
    args = ['mash', 'sketch', '-k', str(kmerlen), '-s', str(sketchsize), '-p', str(n_cpu)]
    if isinstance(assembly_path, Path):
        args.append(assembly_path)
        stdin = None
        log_text = f' - Generating MinHash sketch with Mash for {assembly_path}'
    elif isinstance(assembly_path, Iterable):
        assembly_path = list(assembly_path)
        args += ['-l', _STDIN]
        stdin = '\n'.join(map(str, assembly_path))
        log_text = f' - Generating MinHash sketches with Mash for {len(assembly_path)} assemblies...'
        assembly_path = assembly_path[0]
    else:
        fail(ValueError, 'Invalid assembly_path for mash sketch')

    if out_path is None:
        real_out_path = assembly_path.with_name(assembly_path.name + _MASH_SKETCH_EXT)
        out_path = assembly_path
        logger.warning(f' - mash sketch -o is not provided, output to {real_out_path}')
    elif out_path.suffix == _MASH_SKETCH_EXT:
        real_out_path = out_path
    else:
        real_out_path = out_path.with_name(out_path.name + _MASH_SKETCH_EXT)
    claim_file(real_out_path, overwrite)
    args += ['-o', out_path]

    logger.info(log_text)
    run_tool(*args, stdin=stdin, check=True)
    logger.info(f' - Mash sketch file saved as {real_out_path}')
    return real_out_path


def dist(
    ref_path: Path,
    query_path: Path | None = None,
    n_cpu: int = 1,
) -> Table:
    """Run `mash dist` and parse its table into numpy columns
    ref/query/dist/pval/jaccard/shared/total (jaccard = shared / total)."""
    if query_path is None:
        query_path = ref_path
    logger.info(' - Calculating Mash distances of assembly pairs...')
    cmd_out = run_tool('mash', 'dist', '-p', str(n_cpu), ref_path, query_path)
    table = read_tsv(cmd_out.stdout, ('ref', 'query', 'dist', 'pval', 'jaccard'))
    counts = np.array([str(j).split('/') for j in table['jaccard']],
                      dtype=np.int64).reshape(-1, 2)
    table['shared'], table['total'] = counts[:, 0].copy(), counts[:, 1].copy()
    table['jaccard'] = table['shared'] / table['total']
    return table


def get_jaccard(
    ref_path: Path,
    query_path: Path | None = None,
    n_cpu: int = 1,
    bufsize: int = 1_000_000,
) -> Generator[float, None, None]:
    """Stream `mash dist` output, yielding shared/total per assembly pair."""
    if query_path is None:
        query_path = ref_path
    logger.info(' - Calculating Jaccard indices of assembly pairs...')
    proc = subprocess.Popen(
        ('mash', 'dist', '-p', str(n_cpu), ref_path, query_path),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, bufsize=bufsize,
    )
    try:
        for line in proc.stdout:
            *_, jaccard = line.strip().split('\t')
            shared, total = map(int, jaccard.split('/'))
            yield shared / total
    finally:
        proc.terminate()
        proc.stdout.close()
        _, stderr = proc.communicate()
        if proc.returncode != 0:
            fail(RuntimeError, f"'mash dist' exited with code {proc.returncode}:\n{stderr}")
