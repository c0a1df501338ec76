"""Canonical catalog of every metric name this repo can emit.

``docs/OBSERVABILITY.md`` documents the metric namespace and
``scripts/check_metrics_docs.py`` lints it against this module, so the
catalog — not grep — is the source of truth for "what can show up in a
scrape".  Names are derived the same way the runtime derives them:
dataclass introspection for the ``*Stats`` bridges (``dataclass_gauges``
exports every numeric field), plus the explicitly-registered counters
and histograms, plus the per-op and per-span histogram families expanded
from ``OP_NAMES`` / ``ENGINE_SPANS``.

Unlike the rest of ``repro.obs`` (stdlib-only, imported by every layer)
this module imports back into the repo to introspect the stats
dataclasses — which is why ``repro.obs.__init__`` does not re-export it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from .tracing import ENGINE_SPANS


def _numeric_fields(cls) -> List[str]:
    out = []
    for f in dataclasses.fields(cls):
        if f.type in ("int", "float", int, float):
            out.append(f.name)
    return out


def _dataclass_names(prefix: str, cls) -> List[str]:
    return [f"{prefix}_{name}" for name in _numeric_fields(cls)]


def stats_bridges() -> List[Tuple[str, type]]:
    """(prefix, dataclass) for every ``*Stats`` bridged via
    ``dataclass_gauges`` somewhere in the stack."""
    from ..cache.hierarchy import CacheStats
    from ..cluster.client import RpcStats
    from ..cluster.cluster_store import ClusterStats
    from ..cluster.migration import MigrationStats
    from ..cluster.server import ServerStats
    from ..core.lsm import LSMStats
    from ..core.store import StoreStats
    from ..runtime.executor import ExecutorStats
    from ..runtime.maintenance import MaintenanceStats
    from ..runtime.writebehind import CommitQueueStats
    from ..serving.engine import EngineStats

    return [
        ("repro_server", ServerStats),
        ("repro_store", StoreStats),
        ("repro_lsm", LSMStats),
        ("repro_cluster", ClusterStats),
        ("repro_migration", MigrationStats),
        ("repro_rpc", RpcStats),
        ("repro_engine", EngineStats),
        ("repro_cache", CacheStats),
        ("repro_executor", ExecutorStats),
        ("repro_commit_queue", CommitQueueStats),
        ("repro_maintenance", MaintenanceStats),
    ]


def catalog() -> Dict[str, List[str]]:
    """All emittable metric names, grouped by instrument kind."""
    from ..cluster import protocol as P

    gauges: List[str] = []
    for prefix, cls in stats_bridges():
        gauges.extend(_dataclass_names(prefix, cls))
    # derived values merged via collector ``extra`` callables
    gauges += [
        "repro_engine_mean_ttft_s",
        "repro_engine_mean_ttfb_s",
        "repro_engine_mean_hit",
        "repro_engine_streamed_fetches",
        "repro_cluster_nodes",
        "repro_cluster_live",
        "repro_cluster_replication",
        "repro_migration_active",
        # node backend probes (server-side collector)
        "repro_node_disk_bytes",
        "repro_node_file_count",
    ]

    counters = [
        "repro_node_trace_requests_total",
    ]

    histograms = [
        "repro_node_request_seconds",
        "repro_node_trace_server_span_seconds",
        "repro_engine_ttft_seconds",
        "repro_engine_io_wait_seconds",
    ]
    histograms += [f"repro_node_op_seconds_{name}" for name in P.OP_NAMES.values()]
    histograms += [f"repro_engine_span_seconds_{name}" for name in ENGINE_SPANS]

    return {
        "counters": sorted(set(counters)),
        "gauges": sorted(set(gauges)),
        "histograms": sorted(set(histograms)),
    }


def all_names() -> List[str]:
    cat = catalog()
    return sorted(set(cat["counters"]) | set(cat["gauges"]) | set(cat["histograms"]))


if __name__ == "__main__":
    for kind, names in catalog().items():
        print(f"# {kind}")
        for n in names:
            print(n)
