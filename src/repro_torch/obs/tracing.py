"""Lightweight request tracing.

A :class:`TraceContext` carries an 8-byte trace id and a list of named
span timings.  It is *activated* on the current thread; the single
cheap check everywhere on the hot path is ``current_trace()`` (a
thread-local read), so tracing costs nothing measurable when off.

Propagation:

- ``ServingEngine`` creates a trace per request (when constructed with
  ``tracing=True``) and activates it around plan/fulfill on the engine
  thread.
- ``IOExecutor.submit``/``try_submit`` capture the submitting thread's
  trace and re-activate it inside the worker, so spans recorded in
  ``CacheHierarchy.fetch`` (and any cluster fan-out beneath it) land on
  the right trace without explicit plumbing.
- The cluster client attaches the active trace id to outgoing mux
  frames (``FLAG_TRACE`` + 8 id bytes, see ``cluster/protocol.py``);
  the node server closes the trace out by timing the request into its
  ``repro_node_trace_server_span_seconds`` histogram and remembering
  the id in a recent-traces ring surfaced by ``OP_METRICS``.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

__all__ = [
    "TRACE_ID_BYTES",
    "ENGINE_SPANS",
    "TraceContext",
    "current_trace",
    "activate",
    "maybe_span",
]

TRACE_ID_BYTES = 8

# Every span name the engine-side pipeline can record; enumerated here
# so the metric catalog and docs lint can enumerate the derived
# repro_engine_span_seconds_<name> histograms.
ENGINE_SPANS = ("plan", "fetch", "fulfill", "compute", "commit")

_tls = threading.local()


class TraceContext:
    """One request's trace: an id plus thread-safe span timings.

    Spans are (name, offset_from_trace_start_s, duration_s) tuples;
    multiple spans may share a name (e.g. a hedged fetch records two
    ``fetch`` spans) — ``span_totals`` aggregates by name.
    """

    __slots__ = ("trace_id", "t0", "_spans", "_lock")

    def __init__(self, trace_id: Optional[str] = None):
        self.trace_id = trace_id if trace_id else os.urandom(TRACE_ID_BYTES).hex()
        self.t0 = time.perf_counter()
        self._spans: List[Tuple[str, float, float]] = []
        self._lock = threading.Lock()

    def id_bytes(self) -> bytes:
        return bytes.fromhex(self.trace_id)

    def add_span(self, name: str, start: float, duration_s: float) -> None:
        with self._lock:
            self._spans.append((name, start - self.t0, duration_s))

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.add_span(name, t0, time.perf_counter() - t0)

    @property
    def spans(self) -> List[Tuple[str, float, float]]:
        with self._lock:
            return list(self._spans)

    def span_totals(self) -> Dict[str, float]:
        """Total seconds per span name (hedged/repeated spans summed)."""
        out: Dict[str, float] = {}
        with self._lock:
            for name, _off, dur in self._spans:
                out[name] = out.get(name, 0.0) + dur
        return out


def current_trace() -> Optional[TraceContext]:
    """The trace active on this thread, or None. One thread-local read."""
    return getattr(_tls, "trace", None)


@contextmanager
def activate(trace: Optional[TraceContext]):
    """Make ``trace`` the current trace for the dynamic extent; restores
    the previous one on exit. ``activate(None)`` suppresses tracing."""
    prev = getattr(_tls, "trace", None)
    _tls.trace = trace
    try:
        yield trace
    finally:
        _tls.trace = prev


@contextmanager
def maybe_span(name: str):
    """Record ``name`` on the current trace if one is active, else no-op.

    The inactive path is one thread-local read and a None check — cheap
    enough to leave permanently on the plan/fetch/fulfill hot path.
    """
    tr = getattr(_tls, "trace", None)
    if tr is None:
        yield None
        return
    t0 = time.perf_counter()
    try:
        yield tr
    finally:
        tr.add_span(name, t0, time.perf_counter() - t0)
