"""Assembly distance estimation.

Counterpart: `seqwin_tpu/mash.py`. Two interchangeable estimators of
pairwise Jaccard indices:

1. The external `mash` tool (`sketch`, `dist`, `get_jaccard`), with the
   `mash dist` table parsed without pandas.
2. Bottom-k MinHash sketches computed on the run's device
   (`device_sketches` + `sketch_jaccard_matrix`, ``--sketch-mode device``):
   an assembly's stream is its records joined by runs of 255 separators,
   and its sketch the least distinct canonical hashes of its valid k-mers.

`device_sketches` takes one of two paths, on what it can observe:

- Contiguous k-mers on a card: the cut (`cut_sketches`, kernels
  `sketch_cut` and `sketch_select` of `csrc/sketch.cu`, new in the port).
  Whole assemblies are packed into chunks of at most `CHUNK_BASES`
  positions (`chunk_plan`; a longer assembly alone), staged straight into
  pinned host memory and copied without a sync, so the host fills one chunk
  while the card copies and hashes the last. One `sketch_cut` a chunk
  hashes every position once and keeps, per assembly, the valid hashes
  below its cut tau (`cut_threshold`: about `CUT_FACTOR` x sketch size of
  them) in `cand_cap` slots; one `sketch_select` a job sorts each
  assembly's candidates and writes its least distinct values, and one copy
  to the host brings back the sketches, distinct counts and counters: the
  job's only sync for the sketches. An assembly whose counter passed its
  slots, or that has fewer distinct candidates than the sketch size under a
  cut below all-ones, is redone in full by `_sketch_torch`
  (`needs_fallback`); every other result is exact by construction.
- Otherwise (the CPU, which the host backends and the tests use, and
  spaced seeds): `_sketch_torch` an assembly, torch ops over every position
  and `torch.unique`.

Both give the same sketches bit for bit. Spans (`engine/timeline.py`):
``sketch.join`` (the host staging of a chunk's streams and the enqueue of
its copy, or on the torch path an assembly's join and copy; ``records``,
``bytes``) and ``sketch.fetch`` (the copy of the results to the host, the
host's wait on the device; on the torch path one an assembly). A cut call
counts ``candidates`` (the hashes kept, over every assembly's counter) and
``fallbacks`` (assemblies redone), which `pipeline/kmers.py` sets on its
``threshold.sketches`` span and logs, so a run whose assemblies left the
kernels says so.
"""
from __future__ import annotations

import ctypes
import functools
import logging
import subprocess
from collections.abc import Generator, Iterable
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from .device import resolve_device
from .engine import timeline
from .engine.minimizer import canon_hashes
from .engine._kernels import SMEM_LIMIT
from .engine.phase1 import _window_any, rot_seed_tables
from .ncbi import Table, read_tsv
from .ops import u64
from .ops.hashing import M64
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


def _sketch_torch(records: list[np.ndarray], kmerlen: int, sketchsize: int,
                  seed_pattern: str | None, dev: torch.device) -> np.ndarray:
    """One assembly's sketch with torch ops: its stream joined on the host
    and copied, every position hashed, the bottom-k taken by
    `_bottom_k_tail`. The CPU's and the spaced seeds' path, and the exact
    redo of an assembly the cut cannot settle."""
    n = stream_bases(records, seed_pattern)
    if n == 0:
        return np.zeros(0, np.uint64)
    sep = _separator_run(seed_pattern)
    with timeline.span('sketch.join', records=len(records), bytes=n):
        stream = np.full(n, 255, dtype=np.uint8)
        off = 0
        for c in records:
            stream[off:off + len(c)] = c
            off += len(c) + sep
        codes = torch.from_numpy(stream).to(dev)
    hashes = (_contiguous_canon(codes, kmerlen) if seed_pattern is None
              else spaced_canon(codes, seed_pattern))
    with timeline.span('sketch.fetch'):
        return u64.to_numpy(_bottom_k_tail(*hashes, sketchsize))


# The cut path (kernels `sketch_cut` and `sketch_select`, `csrc/sketch.cu`).
CHUNK_BASES = 1 << 26  # stream positions staged and copied at once
STAGE_PIECE = 1 << 22  # bytes of a record one staging thread copies at once
CUT_TILE = 15360       # positions a block of sketch_cut takes (its kTile)
CUT_FACTOR = 4         # candidates an assembly's cut lets through, in sketch sizes
CAP_FACTOR = 16        # candidate slots an assembly, in sketch sizes
MAX_CAND = 28672       # slots sketch_select sorts in shared memory (224 KiB)


def cand_cap(sketchsize: int) -> int:
    """Candidate slots an assembly."""
    return min(CAP_FACTOR * sketchsize, MAX_CAND)


def cut_threshold(length: int, sketchsize: int) -> int:
    """The cut tau of an assembly whose stream has ``length`` positions:
    floor((2^64 - 1) * min(1, m / length)), m = min(CUT_FACTOR * sketchsize,
    cap / 2), so that about m uniform hashes lie below it. A valid hash h
    is a candidate iff h < tau."""
    m = min(CUT_FACTOR * sketchsize, cand_cap(sketchsize) // 2)
    return M64 if m >= length else M64 * m // length


def chunk_plan(lengths: list[int], budget: int) -> list[tuple[int, int]]:
    """Ranges [a0, a1) of whole assemblies, in order, each chunk's streams
    and the one separator between two of them at most ``budget``
    positions; an assembly longer than that takes a chunk of its own."""
    chunks, a0, used = [], 0, 0
    for a, n in enumerate(lengths):
        if a > a0 and used + 1 + n > budget:
            chunks.append((a0, a))
            a0, used = a, n
        else:
            used = n if a == a0 else used + 1 + n
    if lengths:
        chunks.append((a0, len(lengths)))
    return chunks


def cut_rows(lengths: list[int], chunks: list[tuple[int, int]], sketchsize: int) -> np.ndarray:
    """int64[A, 4], a row an assembly as `sketch_cut` reads it: its offset
    in its chunk, its stream length, its first block in the chunk's grid
    (an assembly takes ceil(length / CUT_TILE) blocks) and its cut (the
    bits of the uint64)."""
    rows = np.zeros((len(lengths), 4), dtype=np.int64)
    for a0, a1 in chunks:
        off = tile = 0
        for a in range(a0, a1):
            n = lengths[a]
            rows[a, :3] = off, n, tile
            rows[a, 3] = u64.as_signed(cut_threshold(n, sketchsize))
            off += n + 1
            tile += -(-n // CUT_TILE)
    return rows


def needs_fallback(distinct: np.ndarray, counters: np.ndarray, taus: np.ndarray,
                   sketchsize: int, cap: int) -> np.ndarray:
    """Assemblies the candidates cannot settle exactly: the counter passed
    the slots (candidates were lost), or fewer than ``sketchsize`` distinct
    candidates under a cut below all-ones (values above the cut may
    belong). Otherwise at least ``sketchsize`` distinct valid hashes lie
    below the cut, so the least ``sketchsize`` of the whole stream do, or
    the cut let every valid hash through."""
    return (counters > cap) | ((distinct < sketchsize) & (taus != np.uint64(M64)))


def stage_chunk(buf: np.ndarray, records_by_assembly: list[list[np.ndarray]], offsets,
                pool: ThreadPoolExecutor | None = None) -> None:
    """Write each assembly's stream into ``buf`` at its offset (records
    joined by one 255 byte), and one 255 byte after each assembly that
    another follows in ``buf``; every byte up to the chunk's end is written.
    The records go in pieces of at most `STAGE_PIECE` bytes, over
    ``pool``'s threads when given (numpy releases the GIL while it
    copies)."""
    end, piece = len(buf), STAGE_PIECE
    pieces = []
    for recs, o in zip(records_by_assembly, offsets):
        o = int(o)
        for i, c in enumerate(recs):
            if i:
                buf[o] = 255
                o += 1
            pieces += [(o + p, c[p:p + piece]) for p in range(0, len(c), piece)]
            o += len(c)
        if o < end:
            buf[o] = 255

    def put(item):
        at, c = item
        buf[at:at + len(c)] = c

    for _ in (map if pool is None else pool.map)(put, pieces):
        pass


def cut_sketches(records_by_assembly: list[list[np.ndarray]], kmerlen: int,
                 sketchsize: int, dev: torch.device, n_cpu: int = 1):
    """Contiguous k-mer sketches by the cut: (sketches, candidates kept,
    assemblies redone). The kernels on a card, their plain versions on the
    CPU; the same sketches as `_sketch_torch` either way. Chunks of at most
    `CHUNK_BASES` positions (read at each call) are staged in min(4,
    ``n_cpu``) threads, with no sync: the host fills the next chunk while
    the card copies and hashes this one."""
    lengths = [stream_bases(recs) for recs in records_by_assembly]
    n_asm = len(lengths)
    if n_asm == 0:
        return [], 0, 0
    budget = CHUNK_BASES
    chunks = chunk_plan(lengths, budget)
    rows = cut_rows(lengths, chunks, sketchsize)
    cap = cand_cap(sketchsize)
    rows_dev = torch.from_numpy(rows)
    if dev.type == 'cuda':
        rows_dev = rows_dev.pin_memory().to(dev, non_blocking=True)
    counts = torch.zeros(n_asm, dtype=torch.int32, device=dev)
    cand = torch.empty(n_asm * cap, dtype=torch.int64, device=dev)
    with ThreadPoolExecutor(max_workers=max(1, min(4, int(n_cpu)))) as pool:
        for a0, a1 in chunks:
            n = int(rows[a1 - 1, 0] + rows[a1 - 1, 1])
            blocks = int(rows[a1 - 1, 2]) + -(-lengths[a1 - 1] // CUT_TILE)
            if blocks == 0:
                continue
            recs = records_by_assembly[a0:a1]
            with timeline.span('sketch.join', records=sum(map(len, recs)), bytes=n):
                # pinned blocks come from torch's caching host allocator, which
                # hands one out again only after the copy that read it is done
                buf = torch.empty(max(n, budget), dtype=torch.uint8,
                                  pin_memory=dev.type == 'cuda')
                stage_chunk(buf.numpy()[:n], recs, rows[a0:a1, 0], pool)
                codes = buf[:n].to(dev, non_blocking=True)
            sketch_cut(codes, rows_dev[a0:a1], kmerlen, cand[a0 * cap:a1 * cap],
                       counts[a0:a1], cap, blocks)
    out = sketch_select(cand, counts, cap, sketchsize)
    with timeline.span('sketch.fetch'):
        host = out.cpu().numpy()
    distinct, counters = host[:, sketchsize], host[:, sketchsize + 1]
    redo = needs_fallback(distinct, counters, rows[:, 3].view(np.uint64), sketchsize, cap)
    sketches = [host[a, :min(int(distinct[a]), sketchsize)].view(np.uint64) for a in range(n_asm)]
    for a in np.flatnonzero(redo):
        sketches[a] = _sketch_torch(records_by_assembly[a], kmerlen, sketchsize, None, dev)
    return sketches, int(counters.sum()), int(redo.sum())


def sketch_cut_plain(codes: torch.Tensor, rows: torch.Tensor, k: int, cand: torch.Tensor,
                     counts: torch.Tensor, cap: int) -> None:
    """Plain torch `sketch_cut`: for each row's assembly of the chunk, its
    valid canonical hashes below the cut appended to its ``cap`` slots of
    ``cand`` in stream order (the kernel's order is any), its counter
    raised by all of them."""
    for j, (off, n, _, tau) in enumerate(rows.tolist()):
        if n < k:
            continue
        h, valid = _contiguous_canon(codes[off:off + n], k)
        keep = h[valid & (u64.key(h) < (tau ^ u64.SIGN))]
        c = int(counts[j])
        lo, hi = min(c, cap), min(c + keep.numel(), cap)
        cand[j * cap + lo:j * cap + hi] = keep[:hi - lo]
        counts[j] += keep.numel()


def sketch_select_plain(cand: torch.Tensor, counts: torch.Tensor, cap: int,
                        size: int) -> torch.Tensor:
    """Plain torch `sketch_select`: int64[A, size + 2], row a the least
    ``size`` distinct of assembly a's min(counter, cap) candidates
    ascending (all-ones past them), their distinct count, the counter."""
    out = torch.full((counts.numel(), size + 2), -1, dtype=torch.int64, device=cand.device)
    for a, c in enumerate(counts.tolist()):
        keys = torch.unique(u64.key(cand[a * cap:a * cap + min(c, cap)]))
        m = min(keys.numel(), size)
        out[a, :m] = keys[:m] ^ u64.SIGN
        out[a, size], out[a, size + 1] = keys.numel(), c
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built and loaded `csrc/sketch.cu` (nvcc runs on the first call)."""
    from .engine._kernels import load

    lib = load('sketch')
    lib.sketch_cut_tile.restype = ctypes.c_int
    lib.sketch_cut_smem_bytes.restype = ctypes.c_longlong
    lib.sketch_cut_smem_bytes.argtypes = [ctypes.c_int]
    lib.sketch_cut_launch.restype = ctypes.c_int
    lib.sketch_cut_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.sketch_select_launch.restype = ctypes.c_int
    lib.sketch_select_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]
    if lib.sketch_cut_tile() != CUT_TILE:
        raise RuntimeError(f'sketch.cu tiles {lib.sketch_cut_tile()} positions, not {CUT_TILE}')
    return lib


def _check(name: str, n_asm: int, cap: int, **tensors) -> None:
    """Raise unless each tensor is contiguous, of its kernel's dtype, on
    the first one's device and large enough for ``n_asm`` assemblies."""
    want = {'codes': (torch.uint8, 0), 'rows': (torch.int64, 4 * n_asm),
            'cand': (torch.int64, cap * n_asm), 'counts': (torch.int32, n_asm)}
    dev = next(iter(tensors.values())).device
    for key, t in tensors.items():
        dtype, numel = want[key]
        if t.dtype != dtype or not t.is_contiguous() or t.device != dev or t.numel() < numel:
            raise ValueError(f'{name}: {key} must be a contiguous {dtype} tensor on {dev} '
                             f'with at least {numel} elements')


def sketch_cut(codes: torch.Tensor, rows: torch.Tensor, k: int, cand: torch.Tensor,
               counts: torch.Tensor, cap: int, blocks: int) -> None:
    """The candidates of one chunk (``rows`` as `cut_rows` gives them),
    over ``blocks`` tiles. CPU tensors take the plain version; CUDA tensors
    launch kernel `sketch_cut` or raise."""
    _check('sketch_cut', rows.shape[0], cap, codes=codes, rows=rows, cand=cand, counts=counts)
    if rows.dim() != 2 or rows.shape[1] != 4 or k < 1:
        raise ValueError(f'sketch_cut: rows must be int64[A, 4] and k >= 1 (k={k})')
    if codes.device.type == 'cpu':
        return sketch_cut_plain(codes, rows, k, cand, counts, cap)
    lib = _lib()
    smem = lib.sketch_cut_smem_bytes(k)
    if smem > SMEM_LIMIT:
        raise ValueError(f'sketch_cut: k={k} needs {smem} B of shared memory per block')
    dev = codes.device
    with torch.cuda.device(dev):
        err = lib.sketch_cut_launch(
            codes.data_ptr(), k, rot_seed_tables(k, dev).data_ptr(), rows.data_ptr(),
            rows.shape[0], blocks, cand.data_ptr(), counts.data_ptr(), cap,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f'sketch_cut launch failed: CUDA error {err}')
    sketch_cut.launches += 1


def sketch_select(cand: torch.Tensor, counts: torch.Tensor, cap: int, size: int) -> torch.Tensor:
    """Each assembly's least ``size`` distinct candidates, their distinct
    count and its counter, int64[A, size + 2]. CPU tensors take the plain
    version; CUDA tensors launch kernel `sketch_select` or raise."""
    _check('sketch_select', counts.numel(), cap, cand=cand, counts=counts)
    if cand.device.type == 'cpu':
        return sketch_select_plain(cand, counts, cap, size)
    dev = cand.device
    out = torch.empty((counts.numel(), size + 2), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = _lib().sketch_select_launch(
            cand.data_ptr(), counts.data_ptr(), counts.numel(), cap, size, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f'sketch_select launch failed: CUDA error {err}')
    sketch_select.launches += 1
    return out


sketch_cut.launches = 0
sketch_select.launches = 0


def device_sketches(
    record_codes_by_assembly: list[list[np.ndarray]],
    kmerlen: int,
    sketchsize: int = 1000,
    seed_pattern: str | None = None,
    device=None,
    n_cpu: int = 1,
    stats: dict | None = None,
) -> list[np.ndarray]:
    """Bottom-k MinHash sketch per assembly, computed on ``device`` (default:
    the GPU; raises when there is none).

    Each assembly is one stream of its records joined by `_separator_run`
    255 bytes; its sketch is the ``sketchsize`` smallest distinct canonical
    hashes of the stream's valid k-mers, uint64 ascending (shorter when the
    assembly has fewer). ``seed_pattern`` switches from contiguous k-mers to
    spaced-seed hashing (`ops/spaced.py`; the pattern's length replaces
    ``kmerlen``). Contiguous k-mers on a card take the cut path
    (`cut_sketches`, staging in min(4, ``n_cpu``) threads) and put its
    ``candidates`` and ``fallbacks`` into ``stats`` when given; any other
    call takes `_sketch_torch` an assembly.
    """
    dev = resolve_device(device)
    if dev.type == 'cuda' and seed_pattern is None:
        sketches, candidates, fallbacks = cut_sketches(
            record_codes_by_assembly, kmerlen, sketchsize, dev, n_cpu=n_cpu)
        if stats is not None:
            stats.update(candidates=candidates, fallbacks=fallbacks)
        return sketches
    return [_sketch_torch(recs, kmerlen, sketchsize, seed_pattern, dev)
            for recs in record_codes_by_assembly]


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
