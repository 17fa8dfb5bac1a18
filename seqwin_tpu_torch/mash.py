"""Assembly distance estimation.

Counterpart: `seqwin_tpu/mash.py`. Two interchangeable estimators of
pairwise Jaccard indices:

1. The external `mash` tool (`sketch`, `dist`, `get_jaccard`), with the
   `mash dist` table parsed without pandas.
2. Bottom-k MinHash sketches computed with torch ops on the run's device
   (`device_sketches` + `sketch_jaccard_matrix`, ``--sketch-mode device``):
   one stream per assembly, its records joined by runs of 255 separators.

Spans (`engine/timeline.py`), one each per assembly: ``sketch.join`` (the
host join of its records into the stream and the copy to the device;
``records``, ``bytes``) and ``sketch.fetch`` (the bottom-k selection and the
read of the sketch to the host: the host's wait on the device).
"""
from __future__ import annotations

import logging
import subprocess
from collections.abc import Generator, Iterable
from pathlib import Path

import numpy as np
import torch

from .device import resolve_device
from .engine import timeline
from .engine.minimizer import canon_hashes
from .engine.phase1 import _window_any
from .ncbi import Table, read_tsv
from .ops import u64
from .ops.spaced import parse_seed, spaced_canon
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


# ---------------------------------------------------------------------------
# Device MinHash sketches
# ---------------------------------------------------------------------------

_MAX_KEY = (1 << 63) - 1  # u64.key of the all-ones hash: "no value"


def _bottom_k_tail(vals: torch.Tensor, valid: torch.Tensor, sketchsize: int) -> torch.Tensor:
    """The ``sketchsize`` smallest distinct valid values (int64 bit
    patterns) in ascending unsigned order. The all-ones hash is the JAX
    package's padding sentinel and never enters a sketch."""
    keys = torch.unique(u64.key(vals[valid]))  # sorted ascending
    return keys[keys != _MAX_KEY][:sketchsize] ^ u64.SIGN


def _contiguous_canon(codes: torch.Tensor, k: int):
    """(canonical ntHash int64[n], valid bool[n]) of the k-mer starting at
    each position of a separator-joined stream (a 255 byte invalidates every
    k-mer spanning it)."""
    n = codes.numel()
    valid = ~_window_any(codes > 3, k) & (torch.arange(n, device=codes.device) <= n - k)
    return canon_hashes(codes, k), valid


def _separator_run(seed_pattern: str | None) -> int:
    """Inter-record separator run length that guarantees no window hashes
    bases from two records.

    For contiguous k-mers every window position is a care position, so ONE
    255 byte invalidates every window spanning it. For a spaced seed, a
    separator landing on a don't-care ('0') position does NOT invalidate the
    window, so a single separator lets windows straddle the junction and hash
    a phantom cross-record k-mer. A run one longer than the pattern's longest
    zero-run closes this: patterns start and end with '1', so a window that
    overlaps the run's edge has a care position (index 0 or k-1) on a
    separator, and a window containing the whole run cannot fit it inside
    any single zero-gap.
    """
    if seed_pattern is None:
        return 1
    _, blocks = parse_seed(seed_pattern)
    max_gap = max(
        (b[0] - a[1] for a, b in zip(blocks, blocks[1:])), default=0)
    return max_gap + 1


def stream_bases(records: list[np.ndarray], seed_pattern: str | None = None) -> int:
    """Positions of one assembly's stream: its records and the separator
    runs between them (one uint8 code each)."""
    return sum(len(c) for c in records) + max(0, len(records) - 1) * _separator_run(seed_pattern)


def device_sketches(
    record_codes_by_assembly: list[list[np.ndarray]],
    kmerlen: int,
    sketchsize: int = 1000,
    seed_pattern: str | None = None,
    device=None,
) -> list[np.ndarray]:
    """Bottom-k MinHash sketch per assembly, computed on ``device`` (default:
    the GPU; raises when there is none).

    Each assembly is one stream of its records joined by `_separator_run`
    255 bytes; its sketch is the ``sketchsize`` smallest distinct canonical
    hashes of the stream's valid k-mers, uint64 ascending (shorter when the
    assembly has fewer). ``seed_pattern`` switches from contiguous k-mers to
    spaced-seed hashing (`ops/spaced.py`; the pattern's length replaces
    ``kmerlen``).
    """
    dev = resolve_device(device)
    sep = _separator_run(seed_pattern)
    sketches = []
    for recs in record_codes_by_assembly:
        n = stream_bases(recs, seed_pattern)
        if n == 0:
            sketches.append(np.zeros(0, np.uint64))
            continue
        with timeline.span('sketch.join', records=len(recs), bytes=n):
            stream = np.full(n, 255, dtype=np.uint8)
            off = 0
            for c in recs:
                stream[off:off + len(c)] = c
                off += len(c) + sep
            codes = torch.from_numpy(stream).to(dev)
        hashes = (_contiguous_canon(codes, kmerlen) if seed_pattern is None
                  else spaced_canon(codes, seed_pattern))
        with timeline.span('sketch.fetch'):
            sketches.append(u64.to_numpy(_bottom_k_tail(*hashes, sketchsize)))
    return sketches


def pair_block(sketchsize: int) -> int:
    """Sketch pairs a `_pair_jaccard` call takes in `sketch_jaccard_matrix`:
    at most 2^24 keys."""
    return max(1, (1 << 24) // (2 * sketchsize))


def _pair_jaccard(S: torch.Tensor, ii: torch.Tensor, jj: torch.Tensor, s: int) -> torch.Tensor:
    """Mash-style Jaccard of sketch-row pairs (rows of unsigned sort keys,
    `_MAX_KEY`-padded): merge the two sorted sketches, keep the smallest s
    distinct values of the union, and count how many occur in both. float64,
    as the JAX package computes it."""
    x = torch.sort(torch.cat([S[ii], S[jj]], 1), 1).values
    real = x != _MAX_KEY
    dup = torch.cat([torch.zeros_like(real[:, :1]), (x[:, 1:] == x[:, :-1]) & real[:, 1:]], 1)
    distinct_rank = torch.cumsum((real & ~dup).long(), 1)
    shared = (dup & (distinct_rank <= s)).sum(1)
    total = distinct_rank[:, -1].clamp(max=s)
    return torch.where(total > 0, shared.double() / total.clamp(min=1).double(), 0.0)


def sketch_jaccard_matrix(sketches: list[np.ndarray], sketchsize: int, device=None) -> np.ndarray:
    """Full pairwise Jaccard matrix (float64) from bottom-k sketches, on
    ``device`` (default: the GPU). The pairs of the upper triangle and the
    diagonal go through `_pair_jaccard` in blocks of at most 2^24 values."""
    dev = resolve_device(device)
    n = len(sketches)
    mtx = np.zeros((n, n), dtype=np.float64)
    if n == 0:
        return mtx
    S = np.full((n, sketchsize), _MAX_KEY, dtype=np.int64)
    for i, sk in enumerate(sketches):
        m = min(len(sk), sketchsize)
        S[i, :m] = np.asarray(sk[:m], dtype=np.uint64).view(np.int64) ^ np.int64(u64.SIGN)
    S_dev = torch.from_numpy(S).to(dev)
    iu, ju = np.triu_indices(n)
    block = pair_block(sketchsize)
    for lo in range(0, len(iu), block):
        sel = slice(lo, lo + block)
        vals = _pair_jaccard(S_dev, torch.from_numpy(iu[sel]).to(dev),
                             torch.from_numpy(ju[sel]).to(dev), sketchsize).cpu().numpy()
        mtx[iu[sel], ju[sel]] = vals
        mtx[ju[sel], iu[sel]] = vals
    return mtx
