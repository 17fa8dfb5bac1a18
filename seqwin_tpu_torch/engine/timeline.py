"""Opt-in host-side event timeline of the graph build.

Counterpart: `seqwin_tpu/engine/timeline.py` (copied). With
``SEQWIN_TPU_TORCH_TIMELINE=1``, `mark()` records (t_monotonic, event,
attrs) tuples in a process-global list; `drain()` returns and clears them.
The build marks each chunk's host prep, h2d and dispatch
(`engine/hybrid.py`: ``prep_start``, ``h2d_submit``, ``h2d_returned``,
``dispatched``), the batched count fetch (`graph/build.py`:
``counts_fetch_start``, ``counts_fetched``) and the aggregation
(`engine/aggregate.py`: ``agg_merge_nodes_done``, ``agg_kn_d2h_done``), so
the gaps between them show whether the host's chunk prep overlaps the card.

A build re-reads the gate when it starts (`gate`). Overhead when disabled:
one cached read and a branch per mark.
"""
from __future__ import annotations

import os
import threading
import time

_events: list[tuple[float, str, dict]] = []
_lock = threading.Lock()
_enabled: bool | None = None


def enabled() -> bool:
    global _enabled
    if _enabled is None:
        _enabled = os.environ.get('SEQWIN_TPU_TORCH_TIMELINE') == '1'
    return _enabled


def gate() -> None:
    """Re-read the env gate; recorded events stay."""
    global _enabled
    _enabled = None


def reset() -> None:
    """Re-read the env gate and clear events (tests / repeated runs)."""
    global _enabled
    with _lock:
        _enabled = None
        _events.clear()


def mark(event: str, **attrs) -> None:
    if not enabled():
        return
    t = time.monotonic()
    with _lock:
        _events.append((t, event, attrs))


def drain() -> list[tuple[float, str, dict]]:
    with _lock:
        out = list(_events)
        _events.clear()
    return out
