"""``IOExecutor`` — the bounded thread pool every runtime service runs on.

The paper's runtime layer (§3.4) moves batch I/O and resource management
off the request path.  This executor is the shared substrate: a fixed pool
of I/O threads plus a *bounded* admission gate, so a burst of submissions
exerts backpressure on the caller instead of growing an unbounded queue
(the failure mode of a naive ``ThreadPoolExecutor``: memory blows up while
the disk falls behind).

Design points:

* ``max_workers == 0`` degenerates to synchronous inline execution — every
  ``submit`` runs the job on the calling thread and returns an
  already-resolved future.  Callers write one code path; serial mode stays
  available for deterministic tests and as the benchmark baseline.
* Admission control: at most ``max_pending`` jobs may be queued or running;
  beyond that ``submit`` blocks (stall time is accounted).  The bound keeps
  the write-behind queue and prefetcher from racing ahead of the disk.
* Observability: queue-depth high-water mark, jobs submitted/completed,
  stall seconds — all maintained under a lock so concurrent readers see
  consistent numbers (the ``EngineStats`` overlap accounting builds on
  these).
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, TypeVar

from ..obs.tracing import activate, current_trace

T = TypeVar("T")


@dataclass
class ExecutorStats:
    submitted: int = 0
    completed: int = 0
    failed: int = 0
    inline: int = 0  # jobs run synchronously (workers == 0)
    queue_depth_max: int = 0
    stall_s: float = 0.0  # time submitters spent blocked on admission

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class IOExecutor:
    """Bounded thread pool with futures, backpressure, and depth accounting.

    Worker count is capped at the host's CPU count: these "I/O" threads do
    real CPU between syscalls (zlib, dequantization, CRC), and
    oversubscribing cores just convoys Python's GIL — measured on a 2-core
    host, 4 workers run *slower* than 2.  The requested width is kept in
    ``requested_workers`` and surfaced by benchmarks, so a sweep over
    configured thread counts stays interpretable on any host.
    """

    def __init__(
        self,
        max_workers: int = 4,
        max_pending: Optional[int] = None,
        cap_to_cpu: bool = True,
    ):
        """``cap_to_cpu=False`` lifts the CPU-count cap for pools whose
        workers block on the *network* with the GIL released (the cluster
        client's RPC fan-out): those threads spend their time in
        ``recv``, not in zlib/numpy, so width beyond the core count buys
        in-flight RPCs instead of GIL convoy."""
        self.requested_workers = max(0, int(max_workers))
        cpu = os.cpu_count() or 1
        self.max_workers = (
            self.requested_workers
            if not cap_to_cpu
            else min(self.requested_workers, max(1, cpu))
        )
        self.max_pending = max_pending if max_pending is not None else 4 * max(1, self.max_workers)
        self.stats = ExecutorStats()
        self._lock = threading.Lock()
        self._in_flight = 0
        self._slot_free = threading.Condition(self._lock)
        self._pool: Optional[ThreadPoolExecutor] = (
            ThreadPoolExecutor(max_workers=self.max_workers, thread_name_prefix="repro-io")
            if self.max_workers > 0
            else None
        )
        self._closed = False

    # ------------------------------------------------------------------ core
    @property
    def serial(self) -> bool:
        return self._pool is None

    def submit(self, fn: Callable[..., T], *args, **kwargs) -> "Future[T]":
        """Run ``fn`` on the pool; blocks when ``max_pending`` jobs are
        already queued/running (backpressure)."""
        if self._closed:
            raise RuntimeError("IOExecutor is closed")
        if self._pool is None:
            fut: Future = Future()
            with self._lock:
                self.stats.submitted += 1
                self.stats.inline += 1
            try:
                fut.set_result(fn(*args, **kwargs))
                with self._lock:
                    self.stats.completed += 1
            except BaseException as e:  # noqa: BLE001 — future carries it
                fut.set_exception(e)
                with self._lock:
                    self.stats.failed += 1
            return fut

        with self._slot_free:
            if self._in_flight >= self.max_pending:
                t0 = time.perf_counter()
                while self._in_flight >= self.max_pending:
                    self._slot_free.wait(timeout=0.5)
                self.stats.stall_s += time.perf_counter() - t0
            self._in_flight += 1
            self.stats.submitted += 1
            self.stats.queue_depth_max = max(self.stats.queue_depth_max, self._in_flight)

        # the submitter's trace follows the job across the thread hop, so
        # spans recorded inside the worker land on the right request
        trace = current_trace()

        def _run():
            try:
                if trace is None:
                    return fn(*args, **kwargs)
                with activate(trace):
                    return fn(*args, **kwargs)
            finally:
                with self._slot_free:
                    self._in_flight -= 1
                    self._slot_free.notify()

        fut = self._pool.submit(_run)
        fut.add_done_callback(self._on_done)
        return fut

    def try_submit(self, fn: Callable[..., T], *args, **kwargs) -> "Optional[Future[T]]":
        """Like ``submit`` but never blocks: returns ``None`` instead of
        waiting when the admission gate is full.  This is the prefetcher's
        probe — checking ``in_flight`` and then calling ``submit`` would
        race other submitters into the very stall the check tried to
        avoid; here the slot is claimed under the same lock that counts
        it."""
        if self._closed:
            raise RuntimeError("IOExecutor is closed")
        if self._pool is None:
            return self.submit(fn, *args, **kwargs)
        with self._slot_free:
            if self._in_flight >= self.max_pending:
                return None
            self._in_flight += 1
            self.stats.submitted += 1
            self.stats.queue_depth_max = max(self.stats.queue_depth_max, self._in_flight)

        trace = current_trace()

        def _run():
            try:
                if trace is None:
                    return fn(*args, **kwargs)
                with activate(trace):
                    return fn(*args, **kwargs)
            finally:
                with self._slot_free:
                    self._in_flight -= 1
                    self._slot_free.notify()

        fut = self._pool.submit(_run)
        fut.add_done_callback(self._on_done)
        return fut

    def _on_done(self, fut: Future) -> None:
        with self._lock:
            if fut.cancelled() or fut.exception() is not None:
                self.stats.failed += 1
            else:
                self.stats.completed += 1

    def map_parallel(self, fn: Callable[..., T], items: Sequence) -> List[T]:
        """Apply ``fn`` to every item, in parallel when the pool exists,
        preserving input order.  Exceptions propagate (first one wins)."""
        if self._pool is None or len(items) <= 1:
            return [fn(it) for it in items]
        futs = [self.submit(fn, it) for it in items]
        return [f.result() for f in futs]

    @property
    def in_flight(self) -> int:
        with self._lock:
            return self._in_flight

    def close(self, wait: bool = True) -> None:
        self._closed = True
        if self._pool is not None:
            self._pool.shutdown(wait=wait)

    def __enter__(self) -> "IOExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
