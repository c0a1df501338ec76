"""Lightweight request tracing.

A :class:`TraceContext` carries an 8-byte trace id and the request's
spans.  It is *activated* on the current thread; the single cheap check
everywhere on the hot path is ``current_trace()`` (a thread-local read),
so tracing costs nothing measurable when off.

Each span (:class:`Span`) keeps its start and end on ``time.perf_counter``
(the process's monotonic clock, which a profiler's trace can be anchored
to), the thread it ran on, its parent, the thread's CPU seconds over it
(``time.thread_time`` at both ends) and an optional count of units (blocks,
say).  The parent is the innermost span of the same trace open on that
thread, or, on a worker, the span that was open when the work was handed to
the worker (see ``current_trace``).

Spans of the served path: ``queue`` (from ``submit`` until the engine
thread starts serving the request), ``plan``, ``fetch`` on an I/O thread
with ``store.probe``, ``store.scan``, ``store.read`` and ``store.decode``
(units: blocks) beneath it, ``io_wait`` (the engine thread blocked on the
fetch), ``fulfill``, ``compute`` with ``prefill.replay`` and
``prefill.copy_out`` beneath it (the real-prefill hook), and ``commit``.
Only ``ENGINE_SPANS`` close into ``repro_engine_span_seconds_<name>``
histograms; the whole trace stays in ``ServingEngine.traces``.  Every span
of a request ends before its trace enters ``ServingEngine.traces``: the
engine waits on the request's one fetch, and the fetch on its workers.  The
engine's ``RequestRecord.ttft_s`` (and so ``repro_engine_ttft_seconds``)
includes ``queue_s``.

Propagation:

- ``ServingEngine`` creates a trace per request (when constructed with
  ``tracing=True``) and activates it around plan/fulfill on the engine
  thread; finished traces go to its :class:`TraceSink`, by request id.
- ``IOExecutor.submit``/``try_submit`` capture the submitting thread's
  trace and re-activate it inside the worker, so spans recorded in
  ``CacheHierarchy.fetch`` (and any cluster fan-out beneath it) land on
  the right trace, under the right parent, without explicit plumbing.
- The cluster client attaches the active trace id to outgoing mux
  frames (``FLAG_TRACE`` + 8 id bytes, see ``cluster/protocol.py``);
  the node server closes the trace out by timing the request into its
  ``repro_node_trace_server_span_seconds`` histogram and remembering
  the id in a recent-traces ring surfaced by ``OP_METRICS``.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "TRACE_ID_BYTES",
    "ENGINE_SPANS",
    "Span",
    "TraceContext",
    "TraceSink",
    "current_trace",
    "activate",
    "maybe_span",
]

TRACE_ID_BYTES = 8

# The engine-side pipeline spans closed into the derived
# repro_engine_span_seconds_<name> histograms; enumerated here so the
# metric catalog and docs lint can enumerate them.  Finer spans (queue,
# io_wait, store.*, prefill.*) stay in the traces and the engine's sink.
ENGINE_SPANS = ("plan", "fetch", "fulfill", "compute", "commit")

# the requests whose finished traces a ``TraceSink`` keeps
TRACE_SINK_CAPACITY = 1024

_tls = threading.local()


class Span:
    """One timed region of a request: ``start``/``end`` on
    ``time.perf_counter``, the thread it ran on, ``parent`` (the ``sid`` of
    the enclosing span, None at a root), ``cpu_s`` (the thread's CPU
    seconds over it; None for a span timed from outside, such as the
    queue) and ``units`` (None where nothing is counted)."""

    __slots__ = ("sid", "name", "start", "end", "thread", "thread_name", "parent", "cpu_s", "units")

    def __init__(self, sid: int, name: str, start: float, end: float, thread: int, thread_name: str,
                 parent: Optional[int], cpu_s: Optional[float] = None, units: Optional[int] = None):
        self.sid, self.name, self.start, self.end = sid, name, start, end
        self.thread, self.thread_name, self.parent = thread, thread_name, parent
        self.cpu_s, self.units = cpu_s, units

    @property
    def wall_s(self) -> float:
        return self.end - self.start

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, sid={self.sid}, parent={self.parent}, thread={self.thread_name!r}, "
                f"wall_s={self.wall_s:.6f}, cpu_s={self.cpu_s}, units={self.units})")


class TraceContext:
    """One request's trace: an id plus thread-safe span records.

    Multiple spans may share a name (``store.read`` under both ``fetch``
    and ``fulfill``); ``span_totals`` aggregates by name.
    """

    __slots__ = ("trace_id", "t0", "_spans", "_lock", "_ids", "_base")

    def __init__(self, trace_id: Optional[str] = None):
        self.trace_id = trace_id if trace_id else os.urandom(TRACE_ID_BYTES).hex()
        self.t0 = time.perf_counter()
        self._spans: List[Span] = []
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._base: Optional[int] = None

    def id_bytes(self) -> bytes:
        return bytes.fromhex(self.trace_id)

    def _at(self, parent: Optional[int]) -> "TraceContext":
        """A view of this trace whose spans, opened on a thread with none
        of the trace open, take ``parent`` as their parent: what a worker
        activates."""
        view = TraceContext.__new__(TraceContext)
        view.trace_id, view.t0, view._spans = self.trace_id, self.t0, self._spans
        view._lock, view._ids, view._base = self._lock, self._ids, parent
        return view

    def _stack_here(self) -> Optional[List[int]]:
        """The open spans of this thread, if this trace is the one active
        on it."""
        cur = getattr(_tls, "trace", None)
        return _tls.open if cur is not None and cur._spans is self._spans else None

    def add_span(self, name: str, start: float, duration_s: float) -> Span:
        """Record a span timed by the caller (``start`` on
        ``time.perf_counter``), on this thread, under the innermost open
        span."""
        t, stack = threading.current_thread(), self._stack_here()
        sp = Span(next(self._ids), name, start, start + duration_s, t.ident, t.name,
                  stack[-1] if stack else self._base)
        with self._lock:
            self._spans.append(sp)
        return sp

    def span(self, name: str, units: Optional[int] = None) -> "_SpanScope":
        """Time a ``with`` block as a span of this trace; the block gets
        the open :class:`Span` (set ``units`` on it before the block
        ends)."""
        return _SpanScope(self, name, units)

    @property
    def records(self) -> List[Span]:
        """Every finished span, in the order they closed."""
        with self._lock:
            return list(self._spans)

    @property
    def spans(self) -> List[Tuple[str, float, float]]:
        """(name, offset from the trace's start, seconds) of every span."""
        with self._lock:
            return [(s.name, s.start - self.t0, s.end - s.start) for s in self._spans]

    def span_totals(self) -> Dict[str, float]:
        """Total seconds per span name (repeated spans summed)."""
        out: Dict[str, float] = {}
        with self._lock:
            for s in self._spans:
                out[s.name] = out.get(s.name, 0.0) + (s.end - s.start)
        return out


class _SpanScope:
    """The ``with`` block of one span: opened on entry (under the
    innermost span open on this thread, if the trace is active here),
    recorded on exit."""

    __slots__ = ("_trace", "_name", "_units", "_span", "_stack")

    def __init__(self, trace: TraceContext, name: str, units: Optional[int]):
        self._trace, self._name, self._units = trace, name, units

    def __enter__(self) -> Span:
        tr, stack = self._trace, self._trace._stack_here()
        t = threading.current_thread()
        sp = Span(next(tr._ids), self._name, time.perf_counter(), 0.0, t.ident, t.name,
                  stack[-1] if stack else tr._base, time.thread_time(), self._units)
        if stack is not None:
            stack.append(sp.sid)
        self._span, self._stack = sp, stack
        return sp

    def __exit__(self, *exc) -> bool:
        sp = self._span
        if self._stack is not None:
            self._stack.pop()
        sp.cpu_s = time.thread_time() - sp.cpu_s
        sp.end = time.perf_counter()
        with self._trace._lock:
            self._trace._spans.append(sp)
        return False


class _NoSpan:
    """The ``with`` block of a span with no trace active: nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


class TraceSink:
    """The finished traces of the last ``TRACE_SINK_CAPACITY`` requests, by
    request id: filled on the engine thread, read after a run (nothing is
    written out on the request path)."""

    def __init__(self):
        self._items: "OrderedDict[int, TraceContext]" = OrderedDict()
        self._lock = threading.Lock()

    def add(self, rid: int, trace: TraceContext) -> None:
        with self._lock:
            self._items.pop(rid, None)
            self._items[rid] = trace
            while len(self._items) > TRACE_SINK_CAPACITY:
                self._items.popitem(last=False)

    def get(self, rid: int) -> Optional[TraceContext]:
        with self._lock:
            return self._items.get(rid)

    def take(self, rids: Iterable[int]) -> Dict[int, TraceContext]:
        """The traces of ``rids`` that the sink still holds."""
        with self._lock:
            return {r: self._items[r] for r in rids if r in self._items}

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def clear(self) -> None:
        with self._lock:
            self._items.clear()


def current_trace() -> Optional[TraceContext]:
    """The trace active on this thread, or None. One thread-local read.

    With a span of it open on this thread, the trace comes back as a view
    whose base is that span: a worker that activates
    it records its spans under the span that handed the work over."""
    tr = getattr(_tls, "trace", None)
    if tr is None or not _tls.open:
        return tr
    return tr._at(_tls.open[-1])


@contextmanager
def activate(trace: Optional[TraceContext]):
    """Make ``trace`` the current trace for the dynamic extent, with no
    span of it open yet on this thread; restores the previous one on exit.
    ``activate(None)`` suppresses tracing."""
    prev, prev_open = getattr(_tls, "trace", None), getattr(_tls, "open", None)
    _tls.trace, _tls.open = trace, []
    try:
        yield trace
    finally:
        _tls.trace, _tls.open = prev, prev_open


def maybe_span(name: str, units: Optional[int] = None):
    """A ``with`` block recording ``name`` on the current trace if one is
    active, else a no-op; the block gets the open :class:`Span` (set its
    ``units`` before the block ends), or None.

    The inactive path is one thread-local read and a None check — cheap
    enough to leave permanently on the plan/fetch/fulfill hot path.
    """
    tr = getattr(_tls, "trace", None)
    if tr is None:
        return _NO_SPAN
    return _SpanScope(tr, name, units)
