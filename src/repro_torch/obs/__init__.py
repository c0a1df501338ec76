"""Observability layer: metrics registry, tracing, and exposition.

Import surface is deliberately light (stdlib only) — ``runtime``,
``cache``, ``core`` and ``cluster`` all import from here, so this
package must not import back into them.  The metric-name catalog
(``repro.obs.catalog``), which *does* import the rest of the repo to
introspect stats dataclasses, is intentionally not re-exported here.
"""

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      dataclass_gauges, render_prometheus)
from .tracing import (ENGINE_SPANS, TRACE_ID_BYTES, TraceContext, activate,
                      current_trace, maybe_span)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "dataclass_gauges",
    "render_prometheus",
    "TraceContext",
    "activate",
    "current_trace",
    "maybe_span",
    "ENGINE_SPANS",
    "TRACE_ID_BYTES",
]
