"""Concurrent runtime layer (paper §3.4 "runtime services"): a bounded
I/O executor, a write-behind commit queue, and an off-path maintenance
service.  The storage backends are thread-safe (see ``core.backend``);
this package supplies the threads."""

from .executor import ExecutorStats, IOExecutor
from .maintenance import MaintenanceService, MaintenanceStats
from .services import RuntimeServices
from .writebehind import CommitQueue, CommitQueueStats

__all__ = [
    "IOExecutor",
    "ExecutorStats",
    "CommitQueue",
    "CommitQueueStats",
    "MaintenanceService",
    "MaintenanceStats",
    "RuntimeServices",
]
