"""Phase 1 of the minimizer scan: per-position clean-window argmin z.

Counterparts: `seqwin_tpu/engine/hybrid.py::scan_phase1` and `pfx_from_z`
for the plain torch versions, and the Pallas kernel
`seqwin_tpu/engine/pallas_scan.py::_make_kernel` for the CUDA kernels of
`csrc/phase1.cu`, one wrapper per mode: `phase1_z` (B1, z mode),
`phase1_zc` (B2, `with_hashes=True`), `phase1_pfx` (B3, `out_mode='pfx'`).
Helpers folded in from `seqwin_tpu/engine/minimizer.py`.

Input: uint8[n], bits 0..5 the base code (0..3 valid), bit 6 the record-start
flag; positions outside the stream behave as padding (255). Output: int32[n],
the stream position of the rightmost minimal canonical hash of the window
[p-w+1, p] where that window is clean (w valid k-mers of one record), else -1.
Irregular windows are resolved on the host (`hybrid.host_patches`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..ops import u64
from ..ops.hashing import M64, SEEDS, SEEDS_COMP, srol
from ._kernels import SMEM_LIMIT

SENTINEL = u64.as_signed(M64)  # -1: the all-ones hash, "no minimum"
_M33 = (1 << 33) - 1
_M31 = (1 << 31) - 1


def next_pow2(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def _srol_parts(x, r33, r31):
    """Split-rotate ``x`` (int64 bit patterns) left by per-element amounts
    r33 in [0, 33) and r31 in [0, 31)."""
    lo = x & _M33
    hi = u64.shr(x, 33)
    lo = ((lo << r33) | (lo >> (33 - r33))) & _M33
    hi = ((hi << r31) | (hi >> (31 - r31))) & _M31
    return (hi << 33) | lo


def _shift_left(a, m: int, fill):
    """out[i] = a[i+m], ``fill`` past the end."""
    if m == 0:
        return a
    return torch.cat([a[m:], torch.full((min(m, a.numel()),), fill, dtype=a.dtype, device=a.device)])[:a.numel()]


def _shift_right(a, m: int, fill):
    """out[i] = a[i-m], ``fill`` before the start."""
    if m == 0:
        return a
    return torch.cat([torch.full((min(m, a.numel()),), fill, dtype=a.dtype, device=a.device), a[:-m]])[:a.numel()]


def _window_xor(a, k: int):
    """W[p] = XOR of a[p..p+k-1], by a disjoint binary decomposition of k
    (XOR windows must not overlap: overlap cancels)."""
    result, result_len = None, 0
    power, j, kk = a, 0, k
    while kk:
        if kk & 1:
            if result is None:
                result, result_len = power, 1 << j
            else:
                result = result ^ _shift_left(power, result_len, 0)
                result_len += 1 << j
        kk >>= 1
        if kk:
            power = power ^ _shift_left(power, 1 << j, 0)
            j += 1
    return result


def _window_any(flags, k: int):
    """OR over flags[p..p+k-1] (True past the end); overlap-tolerant doubling."""
    span, acc = 1, flags
    while span < k:
        step = min(span, k - span)
        acc = acc | _shift_left(acc, step, True)
        span += step
    return acc


def _combine_rmin(lmh, lidx, rmh, ridx):
    """Rightmost-min combine: take the right element iff r <= l (unsigned)."""
    take_r = u64.le(rmh, lmh)
    return torch.where(take_r, rmh, lmh), torch.where(take_r, ridx, lidx)


def _phase1_plain(codes_aug: torch.Tensor, k: int, w: int):
    """Plain torch phase 1: (z int32[n], canon int64[n], valid bool[n])."""
    n = codes_aug.numel()
    dev = codes_aug.device
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    codes = (codes_aug & 63).long()
    is_start = (codes_aug & 64) != 0

    seed = torch.zeros((2, 64), dtype=torch.int64)
    seed[0, :4] = torch.tensor([u64.as_signed(s) for s in SEEDS])
    seed[1, :4] = torch.tensor([u64.as_signed(s) for s in SEEDS_COMP])
    seed = seed.to(dev)
    im33, im31 = iota % 33, iota % 31
    neg33, neg31 = (33 - im33) % 33, (31 - im31) % 31
    a = _srol_parts(seed[0][codes], neg33, neg31)
    b = _srol_parts(seed[1][codes], im33, im31)
    fwd = _srol_parts(_window_xor(a, k), (im33 + k - 1) % 33, (im31 + k - 1) % 31)
    rev = _srol_parts(_window_xor(b, k), neg33, neg31)
    canon = fwd + rev

    bad_base = _window_any(codes > 3, k)
    start_inside = (_window_any(_shift_left(is_start, 1, False), k - 1)
                    if k > 1 else torch.zeros_like(is_start))
    valid = ~bad_base & ~start_inside & (iota <= n - k)
    blocker = ~valid | is_start
    has_blocker_back = _shift_right(_window_any(blocker, w), w - 1, True)
    clean = valid & (iota >= w - 1) & ~has_blocker_back

    # rightmost argmin over [p-w+1, p] by doubling: after the loop, (m, i)
    # covers [p-L+1, p] with L the largest power of two <= w; the window is
    # the union of that span and the one ending w-L positions earlier, and
    # the rightmost-tie combine stays exact under the overlap
    m = torch.where(valid, canon, SENTINEL)
    i = torch.where(valid, iota, -1)
    L = 1
    while 2 * L <= w:
        m, i = _combine_rmin(_shift_right(m, L, SENTINEL), _shift_right(i, L, -1), m, i)
        L *= 2
    if L < w:
        m, i = _combine_rmin(_shift_right(m, w - L, SENTINEL), _shift_right(i, w - L, -1), m, i)
    z = torch.where(clean & (m != SENTINEL), i, -1).to(torch.int32)
    return z, canon, valid


def phase1_z_plain(codes_aug: torch.Tensor, k: int, w: int) -> torch.Tensor:
    """Plain torch phase 1 (the CPU path and kernel B1's oracle)."""
    return _phase1_plain(codes_aug, k, w)[0]


def phase1_zc_plain(codes_aug: torch.Tensor, k: int, w: int):
    """Plain torch phase 1 with hashes (the CPU path and kernel B2's
    oracle): (z int32[n], canon int64[n]), canon 0 where the k-mer is not
    valid (only valid positions are part of the contract)."""
    z, canon, valid = _phase1_plain(codes_aug, k, w)
    return z, torch.where(valid, canon, 0)


def pfx_from_z(z: torch.Tensor, ts: int):
    """Tile-grid inclusive prefix-max of z and tile-local increase counts,
    int32[T, ts] each (kernel B3's outputs, and its oracle). The prefix-max
    restarts at every tile; the tail tile is padded with -1."""
    pad = (-z.numel()) % ts
    if pad:
        z = torch.cat([z, torch.full((pad,), -1, dtype=z.dtype, device=z.device)])
    zt = z.view(-1, ts)
    zpfx = torch.cummax(zt, 1).values
    prev = torch.cat([torch.full_like(zpfx[:, :1], -1), zpfx[:, :-1]], 1)
    lrank = torch.cumsum((zpfx > prev).to(torch.int32), 1, dtype=torch.int32)
    return zpfx, lrank


@functools.lru_cache(maxsize=None)
def rot_seed_tables(k: int, device: torch.device) -> torch.Tensor:
    """Per-offset rotated seed tables as int64 bit patterns, int64[2, k, 4]
    on ``device``: [0, j, c] = srol^(k-1-j)(SEED[c]) and
    [1, j, c] = srol^j(SEED_COMP[c]). Shared by the CUDA kernel (which
    hashes each thread's first k-mer from them and takes its rolling seeds
    SEED[c] = [0, k-1, c] and srol^k(SEED[c]) = srol([0, 0, c]) from them)
    and `hybrid._canon_at_emitted`."""
    fwd = [[u64.as_signed(srol(SEEDS[c], (k - 1 - j) % 1023)) for c in range(4)]
           for j in range(k)]
    rev = [[u64.as_signed(srol(SEEDS_COMP[c], j % 1023)) for c in range(4)]
           for j in range(k)]
    return torch.tensor([fwd, rev], dtype=torch.int64, device=device)


_TILE = 4096            # output positions per CTA (a multiple of 256)
_MODES = {'phase1_z': 0, 'phase1_zc': 1, 'phase1_pfx': 2}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built and loaded kernel library (nvcc runs on the first call)."""
    from ._kernels import load

    lib = load('phase1')
    lib.phase1_smem_bytes.restype = ctypes.c_longlong
    lib.phase1_smem_bytes.argtypes = [ctypes.c_int] * 4
    head = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
    for name, n_out in (('phase1_z', 1), ('phase1_zc', 2), ('phase1_pfx', 2)):
        fn = getattr(lib, f'{name}_launch')
        fn.restype = ctypes.c_int
        fn.argtypes = head + [ctypes.c_void_p] * (n_out + 1)
    return lib


def _launch(name: str, codes_aug: torch.Tensor, k: int, w: int, *outs: torch.Tensor) -> None:
    lib = _lib()
    smem = lib.phase1_smem_bytes(k, w, _TILE, _MODES[name])
    if smem > SMEM_LIMIT:
        raise ValueError(
            f'{name}: k={k}, w={w} needs {smem} B of shared memory per '
            f'block (limit {SMEM_LIMIT})')
    dev = codes_aug.device
    tabs = rot_seed_tables(k, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f'{name}_launch')(
            codes_aug.data_ptr(), codes_aug.numel(), k, w, _TILE, tabs.data_ptr(),
            *(o.data_ptr() for o in outs), stream)
    if err:
        raise RuntimeError(f'{name} launch failed: CUDA error {err}')


def _on_cpu(name: str, codes_aug: torch.Tensor, k: int, w: int) -> bool:
    """Check the input; True for a CPU tensor (the plain version's route),
    False for a CUDA tensor (the kernel's)."""
    if codes_aug.dtype != torch.uint8 or codes_aug.dim() != 1:
        raise TypeError(f'{name}: expected a 1-D uint8 tensor')
    if not codes_aug.is_contiguous():
        raise ValueError(f'{name}: expected a contiguous tensor')
    if k < 1 or w < 1:
        raise ValueError(f'{name}: k={k}, w={w} must be >= 1')
    if codes_aug.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'{name}: unsupported device {codes_aug.device}')
    return codes_aug.device.type == 'cpu'


def phase1_z(codes_aug: torch.Tensor, k: int, w: int) -> torch.Tensor:
    """Phase-1 z stream. A CPU tensor takes the plain version; a CUDA tensor
    launches kernel B1 (`csrc/phase1.cu`) or raises."""
    if _on_cpu('phase1_z', codes_aug, k, w):
        return phase1_z_plain(codes_aug, k, w)
    z = torch.empty(codes_aug.numel(), dtype=torch.int32, device=codes_aug.device)
    _launch('phase1_z', codes_aug, k, w, z)
    phase1_z.launches += 1
    return z


def phase1_zc(codes_aug: torch.Tensor, k: int, w: int):
    """Phase-1 z stream and canonical hashes, (z int32[n], canon int64[n]).
    A CPU tensor takes the plain version; a CUDA tensor launches kernel B2
    (`csrc/phase1.cu`) or raises."""
    if _on_cpu('phase1_zc', codes_aug, k, w):
        return phase1_zc_plain(codes_aug, k, w)
    n, dev = codes_aug.numel(), codes_aug.device
    z = torch.empty(n, dtype=torch.int32, device=dev)
    canon = torch.empty(n, dtype=torch.int64, device=dev)
    _launch('phase1_zc', codes_aug, k, w, z, canon)
    phase1_zc.launches += 1
    return z, canon


def phase1_pfx(codes_aug: torch.Tensor, k: int, w: int):
    """Tile staircases of the phase-1 z stream, (zpfx, lrank int32[T, ts],
    ts) with ts the kernel's tile. A CPU tensor takes the plain version
    (`pfx_from_z` of `phase1_z_plain` at the same ts); a CUDA tensor launches
    kernel B3 (`csrc/phase1.cu`) or raises."""
    if _on_cpu('phase1_pfx', codes_aug, k, w):
        return (*pfx_from_z(phase1_z_plain(codes_aug, k, w), _TILE), _TILE)
    n, dev = codes_aug.numel(), codes_aug.device
    T = -(-n // _TILE)
    zpfx = torch.empty((T, _TILE), dtype=torch.int32, device=dev)
    lrank = torch.empty((T, _TILE), dtype=torch.int32, device=dev)
    _launch('phase1_pfx', codes_aug, k, w, zpfx, lrank)
    phase1_pfx.launches += 1
    return zpfx, lrank, _TILE


phase1_z.launches = 0
phase1_zc.launches = 0
phase1_pfx.launches = 0
