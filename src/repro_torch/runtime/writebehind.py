"""``CommitQueue`` — write-behind population of the disk tier.

``CacheHierarchy.commit`` installs freshly computed KV blocks into device
memory and (until this layer existed) wrote them through to disk *inline*,
charging the disk's write latency to the request's TTFT.  The commit queue
moves that write off the request path: commits are enqueued and a single
drain thread applies them to the backend in FIFO order while the engine
moves on to the next batch.

Bounded, with two backpressure triggers:

* ``max_items`` — pending commit count; and
* ``max_bytes`` — pending payload bytes (the real resource: a queue of
  multi-megabyte KV slabs must not outrun the disk).

When either bound is hit, ``submit`` blocks the producer (stall time
accounted) — write-behind degrades gracefully into write-through under
sustained overload instead of growing without bound.

A single drain thread (not the shared read executor) so queued writes
never starve prefetch reads, and per-store FIFO ordering is preserved.
Failures are captured, counted, and re-raised on the next ``flush`` — a
lost write-behind is a durability event the caller must see.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Optional, Tuple


@dataclass
class CommitQueueStats:
    enqueued: int = 0
    completed: int = 0
    failed: int = 0
    enqueued_bytes: int = 0
    completed_bytes: int = 0
    depth_max: int = 0
    bytes_max: int = 0
    stall_s: float = 0.0  # producer time blocked on backpressure
    drain_s: float = 0.0  # worker time spent applying commits

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class CommitQueue:
    """Bounded FIFO write-behind queue with a dedicated drain thread."""

    def __init__(self, max_items: int = 64, max_bytes: int = 256 * 1024 * 1024):
        self.max_items = max(1, max_items)
        self.max_bytes = max(1, max_bytes)
        self.stats = CommitQueueStats()
        self._q: Deque[Tuple[Callable[[], None], int]] = deque()
        self._pending_bytes = 0
        self._in_flight = 0  # popped but not yet applied
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._idle = threading.Condition(self._lock)
        self._errors: list = []
        self._closed = False
        self._worker = threading.Thread(target=self._drain, name="repro-writebehind", daemon=True)
        self._worker.start()

    # ---------------------------------------------------------------- produce
    def submit(self, fn: Callable[[], None], nbytes: int = 0) -> None:
        """Enqueue one commit closure (blocks under backpressure)."""
        with self._not_full:
            if self._closed:
                raise RuntimeError("CommitQueue is closed")
            if self._full():
                t0 = time.perf_counter()
                while self._full() and not self._closed:
                    self._not_full.wait(timeout=0.5)
                self.stats.stall_s += time.perf_counter() - t0
            self._q.append((fn, nbytes))
            self._pending_bytes += nbytes
            self.stats.enqueued += 1
            self.stats.enqueued_bytes += nbytes
            self.stats.depth_max = max(self.stats.depth_max, len(self._q) + self._in_flight)
            self.stats.bytes_max = max(self.stats.bytes_max, self._pending_bytes)
            self._not_empty.notify()

    def _full(self) -> bool:
        depth = len(self._q) + self._in_flight
        return depth >= self.max_items or self._pending_bytes >= self.max_bytes

    # ------------------------------------------------------------------ drain
    def _drain(self) -> None:
        while True:
            with self._not_empty:
                while not self._q and not self._closed:
                    self._not_empty.wait(timeout=0.5)
                if not self._q and self._closed:
                    return
                fn, nbytes = self._q.popleft()
                self._in_flight += 1
            t0 = time.perf_counter()
            try:
                fn()
                err = None
            except BaseException as e:  # noqa: BLE001 — surfaced via flush()
                err = e
            dt = time.perf_counter() - t0
            with self._lock:
                self._in_flight -= 1
                self._pending_bytes -= nbytes
                self.stats.drain_s += dt
                if err is None:
                    self.stats.completed += 1
                    self.stats.completed_bytes += nbytes
                else:
                    self.stats.failed += 1
                    self._errors.append(err)
                self._not_full.notify()
                if not self._q and self._in_flight == 0:
                    self._idle.notify_all()

    # ------------------------------------------------------------------ sync
    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._q) + self._in_flight

    def flush(self, timeout: Optional[float] = None) -> None:
        """Barrier: wait until every enqueued commit has been applied, then
        re-raise the first captured failure (if any)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._idle:
            while self._q or self._in_flight:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(f"CommitQueue.flush: {len(self._q)} pending after {timeout}s")
                self._idle.wait(timeout=0.2 if remaining is None else min(0.2, remaining))
            if self._errors:
                err = self._errors[0]
                self._errors.clear()
                raise err

    def close(self, flush: bool = True) -> None:
        if flush and not self._closed:
            self.flush()
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()
        self._worker.join(timeout=5.0)
