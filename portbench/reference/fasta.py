"""Plain FASTA reading for the reference.

- A record starts at a line that begins with ``>``; its id is the first
  whitespace-delimited token after the ``>``.
- Sequence bytes are the record's lines with ASCII whitespace removed;
  A/C/G/T/U in either case map to 0/1/2/3 (U as T), anything else to 255, an
  invalid base that no k-mer may contain.
- Marker sequences are sliced from each record's text with only ``\\n``
  removed, upper-cased (upstream Seqwin's loader).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

CODES = np.full(256, 255, dtype=np.uint8)
for _chars, _code in ((b'Aa', 0), (b'Cc', 1), (b'Gg', 2), (b'TtUu', 3)):
    for _ch in _chars:
        CODES[_ch] = _code

_WS = np.zeros(256, dtype=bool)
for _ch in b' \t\n\r\f\v':
    _WS[_ch] = True


def read_records(path: Path) -> tuple[list[str], list[np.ndarray]]:
    """(record ids, base codes per record) of one FASTA file."""
    buf = np.frombuffer(Path(path).read_bytes(), dtype=np.uint8)
    if buf.size == 0:
        return [], []
    gt = np.flatnonzero(buf == ord('>'))
    starts = gt[(gt == 0) | (buf[np.maximum(gt - 1, 0)] == ord('\n'))]
    ends = np.append(starts[1:], buf.size)
    ids, codes = [], []
    for s, e in zip(starts.tolist(), ends.tolist()):
        nl = np.flatnonzero(buf[s:e] == ord('\n'))
        head_end = s + int(nl[0]) if nl.size else e
        header = buf[s + 1:head_end]
        ws = np.flatnonzero(_WS[header])
        ids.append(header[:int(ws[0]) if ws.size else header.size].tobytes().decode())
        body = buf[head_end:e]
        codes.append(CODES[body[~_WS[body]]])
    return ids, codes


def record_texts(path: Path) -> list[str]:
    """Each record's sequence text: ``\\n`` removed, upper-cased."""
    text = Path(path).read_text()
    out = []
    for rec in text.split('>')[1:]:
        nl = rec.find('\n')
        out.append('' if nl == -1 else rec[nl:].replace('\n', '').upper())
    return out
