"""ctypes binding for the native FASTA ingest and sparse canonical hash.

Counterpart: `seqwin_tpu/io/native/__init__.py` (copied: the parse and
`canon_at` entry points, the build, and the ABI guard). The shared library is
compiled with g++ on first use and cached next to this package as
`_fastacodes.so`. Any failure (no compiler, no zlib) falls back to the NumPy
code in `io/fasta.py` and `ops/host_hash.py`, which implement the same
contract.
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile
import threading
import weakref
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / 'fastacodes.cpp'
_LIB_PATH = _HERE / '_fastacodes.so'
_lock = threading.Lock()
_lib = None
_lib_failed = False

# must match fastacodes.cpp::sq_abi_version(); bump together on any contract
# change that keeps old symbols loadable (the mtime check alone cannot catch
# a stale .so copied with preserved timestamps)
_ABI_VERSION = 1


def _build_library() -> Path | None:
    try:
        with tempfile.TemporaryDirectory() as td:
            tmp_so = Path(td) / '_fastacodes.so'
            cmd = [
                'g++', '-O3', '-std=c++17', '-shared', '-fPIC',
                str(_SRC), '-o', str(tmp_so), '-lz',
            ]
            subprocess.run(cmd, check=True, capture_output=True)
            data = tmp_so.read_bytes()
        tmp_out = _LIB_PATH.with_suffix(f'.so.tmp{os.getpid()}')
        tmp_out.write_bytes(data)
        os.replace(tmp_out, _LIB_PATH)
        return _LIB_PATH
    except Exception as e:  # no compiler / no zlib / read-only fs
        logger.debug(f'native ingest build failed, using NumPy parser: {e}')
        return None


def _open() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_LIB_PATH))
    _register(lib)
    return lib


def _load() -> ctypes.CDLL | None:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        fresh = _LIB_PATH.exists() and _LIB_PATH.stat().st_mtime >= _SRC.stat().st_mtime
        if not fresh and _build_library() is None:
            _lib_failed = True
            return None
        try:
            _lib = _open()
        except (OSError, AttributeError) as e:
            # AttributeError: a stale cached .so -- rebuild once, then fall back
            logger.debug(f'native ingest load failed ({e}); rebuilding')
            try:
                if _build_library() is None:
                    raise OSError('rebuild failed')
                _lib = _open()
            except (OSError, AttributeError) as e2:
                logger.debug(f'native ingest rebuild load failed: {e2}')
                _lib_failed = True
        return _lib


def _register(lib: ctypes.CDLL) -> None:
    lib.sq_abi_version.restype = ctypes.c_uint64  # AttributeError if stale
    got = int(lib.sq_abi_version())
    if got != _ABI_VERSION:
        raise AttributeError(
            f'native library ABI {got} != expected {_ABI_VERSION} (stale build)')
    lib.sq_parse.restype = ctypes.c_void_p
    lib.sq_parse.argtypes = [ctypes.c_char_p]
    lib.sq_error.restype = ctypes.c_char_p
    lib.sq_error.argtypes = [ctypes.c_void_p]
    lib.sq_n_records.restype = ctypes.c_uint64
    lib.sq_n_records.argtypes = [ctypes.c_void_p]
    lib.sq_total_bases.restype = ctypes.c_uint64
    lib.sq_total_bases.argtypes = [ctypes.c_void_p]
    lib.sq_codes.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.sq_codes.argtypes = [ctypes.c_void_p]
    lib.sq_offsets.restype = ctypes.POINTER(ctypes.c_uint64)
    lib.sq_offsets.argtypes = [ctypes.c_void_p]
    lib.sq_record_id.restype = ctypes.c_char_p
    lib.sq_record_id.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.sq_free.argtypes = [ctypes.c_void_p]
    canon_args = [
        ctypes.POINTER(ctypes.c_uint8),   # codes / packed
        ctypes.POINTER(ctypes.c_int64),   # positions
        ctypes.c_uint64, ctypes.c_uint64,  # n, k
        ctypes.POINTER(ctypes.c_uint64),  # fwd_tab [k, 5]
        ctypes.POINTER(ctypes.c_uint64),  # rev_tab [k, 5]
        ctypes.POINTER(ctypes.c_uint64),  # out
    ]
    lib.sq_canon_at.restype = None
    lib.sq_canon_at.argtypes = canon_args
    lib.sq_canon_at_packed.restype = None
    lib.sq_canon_at_packed.argtypes = canon_args


def parse_fasta_codes_native(path) -> tuple[list[str], list[np.ndarray]] | None:
    """Native-path equivalent of `io.fasta.parse_fasta_codes`; None if the
    native library is unavailable.

    Zero-copy: the per-record arrays are read-only views over the parse
    handle's code buffer; a finalizer on the shared ctypes window frees the
    handle once the last view dies."""
    lib = _load()
    if lib is None:
        return None
    h = lib.sq_parse(str(path).encode())
    ok = False
    try:
        err = lib.sq_error(h)
        if err:
            raise ValueError(f'{err.decode()}: {path}')
        n_rec = lib.sq_n_records(h)
        total = lib.sq_total_bases(h)
        ids = [lib.sq_record_id(h, i).decode('utf-8', errors='replace') for i in range(n_rec)]
        if n_rec == 0 or not total:
            return ids, [np.zeros(0, dtype=np.uint8) for _ in range(n_rec)]
        offsets = np.ctypeslib.as_array(lib.sq_offsets(h), shape=(n_rec + 1,)).copy()
        # views of views collapse their .base to `win`, so the finalizer runs
        # only after every record array (and any slice of one) is garbage
        win = (ctypes.c_uint8 * total).from_address(
            ctypes.addressof(lib.sq_codes(h).contents))
        weakref.finalize(win, lib.sq_free, h)
        ok = True
        codes_flat = np.frombuffer(win, dtype=np.uint8)
        codes_flat.flags.writeable = False
        return ids, [codes_flat[offsets[i]:offsets[i + 1]] for i in range(n_rec)]
    finally:
        if not ok:
            lib.sq_free(h)


def canon_at(stream: np.ndarray, positions: np.ndarray, k: int,
             fwd_tab: np.ndarray, rev_tab: np.ndarray,
             packed: bool) -> np.ndarray | None:
    """Canonical ntHash at sparse positions via the C loop (L1-resident
    table XORs). Returns None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    pos = np.ascontiguousarray(positions, dtype=np.int64)
    stream = np.ascontiguousarray(stream)
    ft = np.ascontiguousarray(fwd_tab, dtype=np.uint64)
    rt = np.ascontiguousarray(rev_tab, dtype=np.uint64)
    out = np.empty(len(pos), dtype=np.uint64)
    fn = lib.sq_canon_at_packed if packed else lib.sq_canon_at
    fn(
        stream.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(pos), int(k),
        ft.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        rt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    return out
