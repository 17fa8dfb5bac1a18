"""The port's span and counter recorder, and the build's event timeline.

Counterpart of `seqwin_tpu/engine/timeline.py`, whose marks it keeps. Off
unless ``SEQWIN_TPU_TORCH_TIMELINE=1`` (or inside `recording()`); `run`
and each build re-read the gate when they start (`gate`). Every stamp is
`time.time_ns()`, the clock torch.profiler's events carry, so spans and a
profiler trace line up with no offset.

- `span(name, parent=None, **attrs)` times a block of work. When on it
  records a `Span` (id, parent id, run id, name, native thread id, start
  and end ns, attrs) and, where torch.profiler records on the thread,
  enters `torch.profiler.record_function(name)`, so the span also appears
  in the profiler's events (elsewhere one would be invisible and cost
  ~13 us). The
  parent is the innermost open span of the thread, or ``parent``: work
  handed to a pool takes ``parent=current()`` at submit time. The run id
  is the id of the outermost span (`core.run`'s ``run``), so every span of
  one job shares it. Attributes are the span's counters (work counts,
  bytes, child CPU seconds); `Open.set` adds them before the span ends.
  When off, `span` is one cached read and a branch and returns a shared
  null context (falsy, so ``if s:`` guards counters that cost to take).
- `mark(event, **attrs)` records (t_ns, event, attrs) tuples: each chunk's
  host prep, h2d and dispatch (`engine/hybrid.py`: ``prep_start``,
  ``h2d_submit``, ``h2d_returned``, ``dispatched``), the batched count
  fetch (`graph/build.py`: ``counts_fetch_start``, ``counts_fetched``) and
  the aggregation (`engine/aggregate.py`: ``agg_merge_nodes_done``,
  ``agg_kn_d2h_done``). `drain()` returns and clears the marks only.
- Spans keep their own buffer: `spans()` copies it, `drain_spans()`
  clears it, `reset()` clears marks and spans.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from contextlib import contextmanager
from typing import NamedTuple

_events: list[tuple[int, str, dict]] = []
_spans: list = []
_lock = threading.Lock()
_enabled: bool | None = None
_forced = 0
_ids = itertools.count(1)
_local = threading.local()


class Span(NamedTuple):
    id: int
    parent: int | None
    run: int
    name: str
    thread: int          # `threading.get_native_id()`, the profiler's tid
    start_ns: int        # `time.time_ns()`
    end_ns: int
    attrs: dict


def enabled() -> bool:
    global _enabled
    if _enabled is None:
        _enabled = _forced > 0 or os.environ.get('SEQWIN_TPU_TORCH_TIMELINE') == '1'
    return _enabled


def gate() -> None:
    """Re-read the env gate; recorded events and spans stay."""
    global _enabled
    _enabled = None


def reset() -> None:
    """Re-read the env gate and clear marks and spans (tests / repeated runs)."""
    global _enabled
    with _lock:
        _enabled = None
        _events.clear()
        _spans.clear()


@contextmanager
def recording():
    """The recorder on inside the block, whatever the env gate says."""
    global _forced
    _forced += 1
    gate()
    try:
        yield
    finally:
        _forced -= 1
        gate()


def _stack() -> list:
    stack = getattr(_local, 'stack', None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Open:
    """A span being recorded (`span` when on)."""

    __slots__ = ('id', 'parent', 'run', 'name', 'attrs', 'start_ns', '_rf')

    _profiling = None  # torch's check that the profiler records on this thread

    def __init__(self, name: str, parent, attrs: dict):
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.run = parent.run if parent is not None else self.id
        self.name = name
        self.attrs = attrs

    def __bool__(self) -> bool:
        return True

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        if Open._profiling is None:
            from torch._C._autograd import _profiler_enabled
            Open._profiling = _profiler_enabled
        _stack().append(self)
        self._rf = None
        if Open._profiling():
            from torch.profiler import record_function
            self._rf = record_function(self.name)
        self.start_ns = time.time_ns()
        if self._rf is not None:
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        end = time.time_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        rec = Span(self.id, self.parent, self.run, self.name, threading.get_native_id(),
                   self.start_ns, end, self.attrs)
        with _lock:
            _spans.append(rec)
        return False


class _Null:
    """The shared context of every span while the recorder is off."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def span(name: str, parent: Open | None = None, **attrs):
    """A context manager timing its block as span ``name`` (see the module
    docstring); ``parent`` for work running on another thread than the
    one that handed it over."""
    if not enabled():
        return _NULL
    if parent is None:
        stack = _stack()
        parent = stack[-1] if stack else None
    return Open(name, parent, attrs)


def current() -> Open | None:
    """The innermost open span of this thread (None when off or none)."""
    if not enabled():
        return None
    stack = _stack()
    return stack[-1] if stack else None


def spans() -> list[Span]:
    """A copy of the recorded spans, oldest end first."""
    with _lock:
        return list(_spans)


def drain_spans() -> list[Span]:
    with _lock:
        out = list(_spans)
        _spans.clear()
    return out


def mark(event: str, **attrs) -> None:
    if not enabled():
        return
    t = time.time_ns()
    with _lock:
        _events.append((t, event, attrs))


def drain() -> list[tuple[int, str, dict]]:
    """The marks recorded since the last drain (spans stay)."""
    with _lock:
        out = list(_events)
        _events.clear()
    return out
