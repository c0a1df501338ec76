"""Thread-safe metrics core: counters, gauges, and fixed-log-bucket
histograms behind a lock-striped :class:`MetricsRegistry`.

Every instrument is safe to update from ``IOExecutor`` workers, the
engine thread, and the cluster selector threads concurrently.  Locks are
striped: the registry owns a small fixed pool of locks and assigns each
instrument one by name hash, so unrelated hot instruments rarely
contend while the total lock count stays bounded.

Metric naming scheme (enforced by convention, documented in
``docs/OBSERVABILITY.md``): ``repro_<layer>_<what>[_<unit>]``, e.g.
``repro_store_get_blocks``, ``repro_node_request_seconds``.

Existing ``*Stats`` dataclasses are bridged in via *collectors*:
``registry.register_collector(dataclass_gauges("repro_store", store.stats))``
re-exports every numeric field as a gauge at snapshot time, so legacy
stats mutate exactly as before but read out through one registry.
"""

from __future__ import annotations

import threading
import zlib
from bisect import bisect_left
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "dataclass_gauges",
    "render_prometheus",
]

_STRIPES = 16

# Default histogram geometry: 1 microsecond lower bound, doubling
# buckets.  40 buckets span 1e-6 s .. ~550 s, plenty for any latency
# this repo measures; values above the top bound land in +Inf.
DEFAULT_START = 1e-6
DEFAULT_FACTOR = 2.0
DEFAULT_BUCKETS = 40


class Counter:
    """Monotonic counter. ``inc`` only; resets never."""

    __slots__ = ("name", "help", "_lock", "_value")

    def __init__(self, name: str, help: str = "", lock: Optional[threading.Lock] = None):
        self.name = name
        self.help = help
        self._lock = lock or threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """A value that can go up and down (queue depth, open connections)."""

    __slots__ = ("name", "help", "_lock", "_value")

    def __init__(self, name: str, help: str = "", lock: Optional[threading.Lock] = None):
        self.name = name
        self.help = help
        self._lock = lock or threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-log-bucket histogram with cheap ``observe`` and quantile
    estimates by linear interpolation inside the containing bucket.

    Bucket upper bounds are ``start * factor**i`` for ``i`` in
    ``range(buckets)`` with an implicit final ``+Inf`` bucket, matching
    Prometheus ``le`` (cumulative, inclusive-upper) semantics.
    """

    __slots__ = ("name", "help", "_lock", "_bounds", "_counts",
                 "_count", "_sum", "_min", "_max")

    def __init__(self, name: str, help: str = "",
                 start: float = DEFAULT_START, factor: float = DEFAULT_FACTOR,
                 buckets: int = DEFAULT_BUCKETS,
                 lock: Optional[threading.Lock] = None):
        if start <= 0 or factor <= 1.0 or buckets < 1:
            raise ValueError("histogram needs start > 0, factor > 1, buckets >= 1")
        self.name = name
        self.help = help
        self._lock = lock or threading.Lock()
        self._bounds: List[float] = [start * factor ** i for i in range(buckets)]
        self._counts = [0] * (buckets + 1)  # final slot is the +Inf bucket
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")

    @property
    def bounds(self) -> Tuple[float, ...]:
        return tuple(self._bounds)

    def observe(self, value: float) -> None:
        v = float(value)
        idx = bisect_left(self._bounds, v)  # first bound >= v, i.e. v <= le
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    def bucket_index(self, value: float) -> int:
        """Index of the bucket ``observe(value)`` lands in (exposed for tests)."""
        return bisect_left(self._bounds, float(value))

    def quantile(self, q: float) -> float:
        with self._lock:
            return self._quantile_locked(q)

    def _quantile_locked(self, q: float) -> float:
        if self._count == 0:
            return 0.0
        rank = q * self._count
        cum = 0
        for i, c in enumerate(self._counts):
            if c == 0:
                continue
            prev = cum
            cum += c
            if cum >= rank:
                hi = self._bounds[i] if i < len(self._bounds) else self._max
                lo = self._bounds[i - 1] if i > 0 else 0.0
                hi = min(hi, self._max)
                lo = max(lo, self._min if self._min <= hi else lo)
                if hi <= lo:
                    return hi
                frac = (rank - prev) / c
                return lo + (hi - lo) * frac
        return self._max

    def snapshot(self) -> dict:
        with self._lock:
            cum = 0
            buckets = []
            for i, c in enumerate(self._counts[:-1]):
                cum += c
                buckets.append([self._bounds[i], cum])
            buckets.append([float("inf"), cum + self._counts[-1]])
            return {
                "count": self._count,
                "sum": self._sum,
                "min": self._min if self._count else 0.0,
                "max": self._max if self._count else 0.0,
                "p50": self._quantile_locked(0.50),
                "p95": self._quantile_locked(0.95),
                "p99": self._quantile_locked(0.99),
                "buckets": buckets,
            }


class MetricsRegistry:
    """Named instruments plus read-time *collectors*.

    Instruments are get-or-create by name (re-registering with the same
    name and type returns the existing instrument; a type clash raises).
    Collectors are zero-arg callables returning ``{full_name: value}``
    dicts, merged into the gauge section of every snapshot — the bridge
    that lets the existing ``*Stats`` dataclasses keep their in-place
    mutation style while exporting through the registry.
    """

    def __init__(self, stripes: int = _STRIPES):
        self._meta = threading.Lock()
        self._stripes = [threading.Lock() for _ in range(max(1, stripes))]
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._collectors: List[Callable[[], Dict[str, float]]] = []

    def _stripe(self, name: str) -> threading.Lock:
        return self._stripes[zlib.crc32(name.encode()) % len(self._stripes)]

    def counter(self, name: str, help: str = "") -> Counter:
        with self._meta:
            got = self._counters.get(name)
            if got is not None:
                return got
            self._check_free(name, self._counters)
            c = Counter(name, help, lock=self._stripe(name))
            self._counters[name] = c
            return c

    def gauge(self, name: str, help: str = "") -> Gauge:
        with self._meta:
            got = self._gauges.get(name)
            if got is not None:
                return got
            self._check_free(name, self._gauges)
            g = Gauge(name, help, lock=self._stripe(name))
            self._gauges[name] = g
            return g

    def histogram(self, name: str, help: str = "",
                  start: float = DEFAULT_START, factor: float = DEFAULT_FACTOR,
                  buckets: int = DEFAULT_BUCKETS) -> Histogram:
        with self._meta:
            got = self._histograms.get(name)
            if got is not None:
                return got
            self._check_free(name, self._histograms)
            h = Histogram(name, help, start=start, factor=factor,
                          buckets=buckets, lock=self._stripe(name))
            self._histograms[name] = h
            return h

    def _check_free(self, name: str, own: dict) -> None:
        for kind, table in (("counter", self._counters),
                            ("gauge", self._gauges),
                            ("histogram", self._histograms)):
            if table is not own and name in table:
                raise ValueError(f"metric {name!r} already registered as a {kind}")

    def register_collector(self, fn: Callable[[], Dict[str, float]]) -> None:
        with self._meta:
            self._collectors.append(fn)

    def metric_names(self) -> List[str]:
        """Every name this registry can emit right now (instruments plus
        whatever the collectors currently produce)."""
        snap = self.snapshot()
        names = set(snap["counters"]) | set(snap["gauges"]) | set(snap["histograms"])
        return sorted(names)

    def snapshot(self) -> dict:
        with self._meta:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            hists = list(self._histograms.items())
            collectors = list(self._collectors)
        out = {
            "counters": {c.name: c.value for c in counters},
            "gauges": {g.name: g.value for g in gauges},
            "histograms": {name: h.snapshot() for name, h in hists},
        }
        for fn in collectors:
            try:
                produced = fn()
            except Exception:
                continue  # a broken collector must never break the scrape
            for name, value in produced.items():
                try:
                    out["gauges"][name] = float(value)
                except (TypeError, ValueError):
                    continue
        return out

    def render_prometheus(self) -> str:
        return render_prometheus(self.snapshot())


def dataclass_gauges(prefix: str, obj: object,
                     lock: Optional[threading.Lock] = None,
                     extra: Optional[Callable[[], Dict[str, float]]] = None,
                     ) -> Callable[[], Dict[str, float]]:
    """Collector over every numeric attribute of a stats object.

    Reads ``obj.__dict__`` at snapshot time, exporting int/float fields
    as ``<prefix>_<field>`` gauges (bools and non-numerics skipped).
    ``lock`` is taken during the read when the stats object has one;
    ``extra`` merges derived values (means, list lengths) on top.
    """

    def collect() -> Dict[str, float]:
        out: Dict[str, float] = {}
        if lock is not None:
            lock.acquire()
        try:
            fields = dict(vars(obj))
        finally:
            if lock is not None:
                lock.release()
        for k, v in fields.items():
            if k.startswith("_") or isinstance(v, bool):
                continue
            if isinstance(v, (int, float)):
                out[f"{prefix}_{k}"] = float(v)
        if extra is not None:
            for k, v in extra().items():
                out[k] = float(v)
        return out

    return collect


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def render_prometheus(snapshot: dict) -> str:
    """Prometheus text-format (0.0.4) exposition of a registry snapshot.

    Histograms render the standard ``_bucket{le=...}`` / ``_count`` /
    ``_sum`` series plus non-standard ``_p50/_p95/_p99`` gauge
    convenience series (documented in docs/OBSERVABILITY.md).
    """
    lines: List[str] = []
    for name in sorted(snapshot.get("counters", {})):
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name} {_fmt(snapshot['counters'][name])}")
    for name in sorted(snapshot.get("gauges", {})):
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {_fmt(snapshot['gauges'][name])}")
    for name in sorted(snapshot.get("histograms", {})):
        h = snapshot["histograms"][name]
        lines.append(f"# TYPE {name} histogram")
        for le, cum in h["buckets"]:
            lines.append(f'{name}_bucket{{le="{_fmt(le)}"}} {int(cum)}')
        lines.append(f"{name}_count {int(h['count'])}")
        lines.append(f"{name}_sum {_fmt(h['sum'])}")
        for q in ("p50", "p95", "p99"):
            lines.append(f"# TYPE {name}_{q} gauge")
            lines.append(f"{name}_{q} {_fmt(h[q])}")
    return "\n".join(lines) + "\n"
