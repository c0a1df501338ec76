"""``RuntimeServices`` — the bundle the serving layer plugs in.

One object wires the three runtime components together with sane defaults:

* ``executor``   — ``IOExecutor`` for prefetch fan-out and hedged reads;
* ``commits``    — ``CommitQueue`` write-behind for disk population;
* ``maintenance``— ``MaintenanceService`` (bound lazily to the hierarchy
                   by the engine, since the engine owns the hierarchy).

``io_threads == 0`` yields a fully synchronous runtime (inline executor,
no write-behind, inline maintenance) — the serial baseline every benchmark
compares against, through the *same* code paths.
"""

from __future__ import annotations

from typing import Callable, Optional

from .executor import IOExecutor
from .maintenance import MaintenanceService
from .writebehind import CommitQueue


class RuntimeServices:
    def __init__(
        self,
        io_threads: int = 4,
        max_pending: Optional[int] = None,
        commit_queue_items: int = 64,
        commit_queue_bytes: int = 256 * 1024 * 1024,
    ):
        self.io_threads = max(0, int(io_threads))
        if max_pending is None:
            # generous admission bound: prefetch-ahead submits a whole
            # batch of fetches before the engine starts serving — the gate
            # exists to stop runaway producers, not to throttle one batch
            # (a tight bound stalls the *engine thread* mid-step)
            max_pending = max(32, 8 * max(1, self.io_threads))
        self.executor = IOExecutor(max_workers=self.io_threads, max_pending=max_pending)
        self.commits: Optional[CommitQueue] = (
            CommitQueue(max_items=commit_queue_items, max_bytes=commit_queue_bytes)
            if self.io_threads > 0
            else None
        )
        self.maintenance: Optional[MaintenanceService] = None

    @property
    def async_mode(self) -> bool:
        return self.io_threads > 0

    def bind_maintenance(self, target: Callable[[], dict]) -> MaintenanceService:
        if self.maintenance is None:
            self.maintenance = MaintenanceService(target)
        return self.maintenance

    def report(self) -> dict:
        out = {"io_threads": self.io_threads, "executor": self.executor.stats.as_dict()}
        if self.commits is not None:
            out["commit_queue"] = self.commits.stats.as_dict()
        if self.maintenance is not None:
            out["maintenance"] = self.maintenance.stats.as_dict()
        return out

    def drain(self) -> None:
        """Quiesce: flush write-behind, wait out maintenance."""
        if self.commits is not None:
            self.commits.flush()
        if self.maintenance is not None:
            self.maintenance.drain()

    def close(self) -> None:
        if self.commits is not None:
            self.commits.close(flush=True)
        if self.maintenance is not None:
            self.maintenance.drain()
        self.executor.close()

    def __enter__(self) -> "RuntimeServices":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
