"""Host-side FASTA ingest.

Counterpart: `seqwin_tpu/io/fasta.py` (copied: `parse_fasta_codes` and its
NumPy fallback, and `load_fasta`, the marker sequence fetch's loader).
Parsing semantics of `parse_fasta_codes`:

- plain or gzip input (gzip iff the path ends with ``.gz``)
- trailing ``\\r`` stripped per line; blank / whitespace-only lines skipped
- record id = first whitespace-delimited token after ``>``
- intra-line ASCII whitespace removed from sequence lines
- a sequence line before any header is an error

Sequences come back as base-code uint8 arrays (0..3, 255 for any non-ACGTU
byte).
"""
from __future__ import annotations

import gzip
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..engine import timeline
from ..ops.hashing import CODE_TAB

_WS_BYTES = np.zeros(256, dtype=bool)
for _b in b' \t\n\r\f\v':
    _WS_BYTES[_b] = True

GZIP_EXT = '.gz'
U32_MAX = (1 << 32) - 1


def _read_bytes(path: str | Path) -> bytes:
    path = str(path)
    if path.endswith(GZIP_EXT):
        with open(path, 'rb') as f:
            raw = f.read()
        # zlib with gzip wrapper; wbits=47 also accepts zlib streams like gzread
        try:
            return zlib.decompress(raw, wbits=47)
        except zlib.error:
            # multi-member gzip
            return gzip.decompress(raw)
    with open(path, 'rb') as f:
        return f.read()


def parse_fasta_codes(path: str | Path) -> tuple[list[str], list[np.ndarray]]:
    """Parse a FASTA file into record ids and base-code arrays.

    Uses the native C++ scanner (`io/native`) when it builds, with a NumPy
    fallback implementing the identical contract.
    """
    from . import native

    result = native.parse_fasta_codes_native(path)
    if result is not None:
        return result
    return parse_fasta_codes_py(path)


def parse_fasta_codes_py(path: str | Path) -> tuple[list[str], list[np.ndarray]]:
    """Pure-NumPy FASTA parser (fallback)."""
    data = _read_bytes(path)
    buf = np.frombuffer(data, dtype=np.uint8)
    n = buf.size
    if n == 0:
        return [], []

    # Line starts: position 0 plus one past every '\n'.
    nl = np.flatnonzero(buf == ord('\n'))
    line_starts = np.concatenate(([0], nl + 1))
    line_stops = np.concatenate((nl, [n]))
    if line_starts[-1] >= n:  # trailing newline -> drop empty final line
        line_starts = line_starts[:-1]
        line_stops = line_stops[:-1]

    # Strip one trailing '\r' per line.
    has_cr = (line_stops > line_starts) & (buf[np.minimum(line_stops - 1, n - 1)] == ord('\r'))
    line_stops = line_stops - has_cr

    is_header = (line_stops > line_starts) & (buf[np.minimum(line_starts, n - 1)] == ord('>'))

    # Whitespace mask over the whole buffer (newlines count as whitespace).
    ws = _WS_BYTES[buf]

    record_ids: list[str] = []
    record_codes: list[np.ndarray] = []

    header_idx = np.flatnonzero(is_header)
    first_hdr = header_idx[0] if header_idx.size else len(line_starts)
    for s, e in zip(line_starts[:first_hdr], line_stops[:first_hdr]):
        if e > s and not ws[s:e].all():
            raise ValueError(f'Invalid FASTA: sequence encountered before header: {path}')
    if header_idx.size == 0:
        return [], []

    # Sequence region of record i: from the line after header i to the start
    # of header line i+1 (or EOF).
    hdr_starts = line_starts[header_idx]
    hdr_stops = line_stops[header_idx]
    next_line_idx = header_idx + 1
    region_starts = np.where(
        next_line_idx < len(line_starts), line_starts[np.minimum(next_line_idx, len(line_starts) - 1)], n
    )
    region_stops = np.concatenate((hdr_starts[1:], [n]))

    for i in range(len(header_idx)):
        hs, he = int(hdr_starts[i]) + 1, int(hdr_stops[i])
        header = buf[hs:he]
        ws_in_header = np.flatnonzero(_WS_BYTES[header])
        id_end = int(ws_in_header[0]) if ws_in_header.size else header.size
        record_ids.append(header[:id_end].tobytes().decode('utf-8', errors='replace'))

        rs, re_ = int(region_starts[i]), int(region_stops[i])
        if re_ <= rs:
            record_codes.append(np.zeros(0, dtype=np.uint8))
            continue
        region = buf[rs:re_]
        seq_bytes = region[~_WS_BYTES[region]]
        record_codes.append(CODE_TAB[seq_bytes])

    return record_ids, record_codes


def load_fasta(path: str | Path) -> tuple[str, ...]:
    """Sequences of FASTA records, upper-cased, for marker sequence fetch.

    Mirrors the reference's Python loader: only ``\\n`` characters are
    stripped from sequence bodies (not ``\\r`` or spaces), and the result is
    upper-cased -- the extracted signature sequences must match that loader
    byte for byte.
    """
    path = Path(path)
    if path.suffix == GZIP_EXT:
        content = gzip.decompress(path.read_bytes()).decode()
    else:
        content = path.read_text()
    if not content or content[0] != '>':
        raise ValueError(f"FASTA file must start with '>', in: {path}")
    seqs: list[str] = []
    for record in content.split('>')[1:]:
        header_pos = record.find('\n')
        if header_pos == -1:
            seqs.append('')
        else:
            seqs.append(record[header_pos:].replace('\n', '').upper())
    return tuple(seqs)


def _parse_in_span(path, parent) -> tuple[list[str], list[np.ndarray]]:
    """`parse_fasta_codes` as span ``io.parse`` (file bytes, records), a
    child of ``parent``."""
    with timeline.span('io.parse', parent=parent) as s:
        ids, codes_list = parse_fasta_codes(path)
        if s:
            s.set(bytes=os.path.getsize(path), records=len(ids))
    return ids, codes_list


def iter_assemblies(paths: list[str], n_cpu: int):
    """Yield (record ids, per-record base codes) of each assembly in order,
    parsed in worker threads (span ``io.parse`` each, a child of the span
    open at this call), after the uint32 range checks."""
    return _iter_assemblies(paths, n_cpu, timeline.current())


def _iter_assemblies(paths: list[str], n_cpu: int, parent):
    n_records = 0
    with ThreadPoolExecutor(max_workers=max(1, min(int(n_cpu), len(paths) or 1))) as ex:
        for pi, (ids, codes_list) in enumerate(
                ex.map(_parse_in_span, paths, [parent] * len(paths))):
            n_records += len(ids)
            if n_records > U32_MAX:
                raise ValueError('Total number of FASTA records exceeds uint32 range')
            for rid, codes in zip(ids, codes_list):
                if len(codes) > U32_MAX:
                    raise ValueError(
                        f'Sequence length exceeds uint32 range for record {rid} in assembly {paths[pi]}')
            yield ids, codes_list
