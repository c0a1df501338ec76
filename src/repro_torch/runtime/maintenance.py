"""``MaintenanceService`` — compaction/merge/eviction cycles off the
request path.

The stores' ``maintenance()`` contract stays deterministic and
caller-scheduled; this service is the caller.  The serving engine used to
run ``hierarchy.maintenance()`` inline between batches, so a compaction
cascade or a tensor-file merge landed squarely on request latency.  Now the
engine calls ``maybe_schedule()`` — a non-blocking nudge — and the cycle
runs on the maintenance thread while the engine keeps serving (the backends
are thread-safe; see ``core.backend``).

At most one cycle is in flight at a time (maintenance is bounded work per
cycle by design; overlapping cycles would just contend on the same locks).
Reports are aggregated under a lock; ``harvest()`` hands the counters to
the engine's single-writer stats on the engine thread, so ``EngineStats``
stays race-free.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional


@dataclass
class MaintenanceStats:
    cycles: int = 0
    compactions: int = 0
    evicted_files: int = 0
    merged_files: int = 0
    demoted_blocks: int = 0  # blocks re-encoded down-tier (core.tiering)
    errors: int = 0
    busy_s: float = 0.0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class MaintenanceService:
    """Runs ``target()`` maintenance cycles on a background thread."""

    def __init__(self, target: Callable[[], dict]):
        self.target = target
        self.stats = MaintenanceStats()
        self._lock = threading.Lock()
        self._running = False
        self._pending = 0
        self._idle = threading.Condition(self._lock)
        self._last_error: Optional[BaseException] = None
        # counters not yet harvested by the engine thread
        self._unharvested = MaintenanceStats()

    # -------------------------------------------------------------- schedule
    def maybe_schedule(self) -> bool:
        """Start one cycle unless one is already in flight.  Returns True
        when a new cycle was scheduled."""
        with self._lock:
            if self._running:
                self._pending = 1  # coalesce: run once more after this cycle
                return False
            self._running = True
        t = threading.Thread(target=self._cycle, name="repro-maintenance", daemon=True)
        t.start()
        return True

    def run_inline(self) -> dict:
        """Synchronous cycle (serial mode / tests): same accounting path."""
        return self._run_once()

    def _cycle(self) -> None:
        while True:
            self._run_once()
            with self._lock:
                if self._pending:
                    self._pending = 0
                    continue
                self._running = False
                self._idle.notify_all()
                return

    def _run_once(self) -> dict:
        t0 = time.perf_counter()
        try:
            rep = self.target() or {}
            err = None
        except BaseException as e:  # noqa: BLE001 — counted, surfaced on drain
            rep, err = {}, e
        dt = time.perf_counter() - t0
        with self._lock:
            for agg in (self.stats, self._unharvested):
                agg.cycles += 1
                agg.busy_s += dt
                agg.compactions += int(rep.get("compactions", 0) or 0)
                agg.evicted_files += int(rep.get("evicted_files", 0) or 0)
                merge = rep.get("merge") or {}
                agg.merged_files += int(merge.get("files", 0) or 0)
                tiering = rep.get("tiering") or {}
                agg.demoted_blocks += int(tiering.get("demoted_blocks", 0) or 0)
                if err is not None:
                    agg.errors += 1
            if err is not None:
                self._last_error = err
        return rep

    # --------------------------------------------------------------- harvest
    def harvest(self) -> MaintenanceStats:
        """Return-and-reset the counters accumulated since the last harvest
        (called from the engine thread to fold into ``EngineStats``)."""
        with self._lock:
            out = self._unharvested
            self._unharvested = MaintenanceStats()
            return out

    def drain(self, timeout: float = 30.0) -> None:
        """Wait for the in-flight cycle (if any); re-raise its error."""
        deadline = time.monotonic() + timeout
        with self._idle:
            while self._running:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("MaintenanceService.drain timed out")
                self._idle.wait(timeout=min(0.2, remaining))
            if self._last_error is not None:
                err = self._last_error
                self._last_error = None
                raise err
