"""Build and load the port's hand-written CUDA kernels.

New in the port. Each ``csrc/<name>.cu`` is compiled at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``_build/lib<name>.<source hash>.so`` inside this package (listed in
``.gitignore``) and loaded with ctypes. The sources expose a plain C
interface, so the build never includes PyTorch's headers and takes seconds.
Nothing here runs at import time: a CPU-only machine has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / '_build'
SMEM_LIMIT = 232448  # dynamic shared memory a block may use on Hopper


def _nvcc() -> str:
    for cand in (shutil.which('nvcc'),
                 os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'nvcc')):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on PATH)')


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f'{name}.cu').read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f'lib{name}.{digest}.so'


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of the same source exists."""
    out = _lib_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.so.tmp{os.getpid()}.{threading.get_ident()}')
    cmd = [_nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
           '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
           '-o', str(tmp), str(CSRC / f'{name}.cu')]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f'nvcc failed for {name}.cu:\n{res.stdout}{res.stderr}')
    (BUILD_DIR / f'{name}.ptxas.txt').write_text(res.stdout + res.stderr)
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Load the shared library of ``csrc/<name>.cu``, building it first if
    needed. Callers keep the handle (`phase1._lib`)."""
    return ctypes.CDLL(str(build(name)))
