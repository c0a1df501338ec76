"""Device traces of a sub-window of a traced run (``--trace 1``):
torch.profiler over CPU and CUDA activity, started and stopped at request
or step boundaries with the device synchronised, reduced once the run's
window has closed to what the per-layer readers and the result's
``breakdown`` need.

Host spans are the benchmark's own: ``Spans.wrap(fn, name)`` times a call
into one of the program's layers on whatever thread it runs (the cache's
fetch runs on the I/O executor), so an idle gap on the device is named by
what the host was doing in it.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

ANCHOR = "kvbench.anchor"

# the program's kernels, by the __global__ names of their sources
KERNELS = {
    "flash": re.compile(r"\bflash_(bf16|fwd)_kernel\b"),
    "paged_decode": re.compile(r"\bpaged_decode_(mma|split|join)_kernel\b"),
}


class Spans:
    """(name, start, end) on the host clock, from any thread."""

    def __init__(self):
        self.items: List[Tuple[str, float, float]] = []
        self._lock = threading.Lock()

    def wrap(self, fn, name: str):
        def spanned(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                end = time.perf_counter()
                with self._lock:
                    self.items.append((name, t, end))
        return spanned


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class DeviceWindow:
    """One profiled window: ``start()`` and ``stop()`` synchronise the device
    and read the host clock; ``summary()``, called once the run's window has
    closed, reduces the trace (its cost stays out of the window)."""

    def __init__(self, device, spans: Optional[Spans] = None):
        self.device = torch.device(device)
        self.spans = spans
        self.prof = None
        self.t0 = self.t1 = self.t_anchor = 0.0
        self.stopped = False

    @property
    def fresh(self) -> bool:
        return self.prof is None

    @property
    def open(self) -> bool:
        return self.prof is not None and not self.stopped

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._sync()
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        with torch.profiler.record_function(ANCHOR):
            self.t_anchor = time.perf_counter()
        self.t0 = self.t_anchor

    def stop(self) -> None:
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.stopped = True

    def summary(self) -> Optional[Dict]:
        if not self.stopped:
            return None
        events = self.prof.events()
        anchor = next((e.time_range.start for e in events if e.name == ANCHOR), None)
        host = []
        if self.spans is not None and anchor is not None:
            host = [(n, anchor + (s - self.t_anchor) * 1e6, anchor + (e - self.t_anchor) * 1e6)
                    for n, s, e in self.spans.items if e >= self.t0 and s <= self.t1]
        return summarise(events, self.t1 - self.t0, host)


def summarise(events, window_s: float, host: List[Tuple[str, float, float]]) -> Dict:
    """busy seconds (the union of device operations), kernel seconds and
    counts by name, the 10 device operations of most total time, and the 10
    longest idle gaps, each named by the shortest host span open at its
    midpoint ("host" where none is)."""
    dev = [(e.name, e.time_range.start, e.time_range.end) for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("kvbench.")]
    by_name: Dict[str, List[float]] = {}
    for name, s, e in dev:
        acc = by_name.setdefault(name, [0, 0.0])
        acc[0] += 1
        acc[1] += (e - s) * 1e-6
    busy = merge([(s, e) for _, s, e in dev])
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps = []
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        inside = [(se - ss, n) for n, ss, se in host if ss <= mid <= se]
        gaps.append((min(inside)[1] if inside else "host", (s1 - e0) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(([n, v[1]] for n, v in by_name.items()), key=lambda o: -o[1])
    kernels = {k: [0, 0.0] for k in KERNELS}
    for name, (n, sec) in by_name.items():
        for k, pat in KERNELS.items():
            if pat.search(name):
                kernels[k][0] += n
                kernels[k][1] += sec
    return {"window_s": window_s, "busy_s": busy_s, "kernels": kernels,
            "device_ops": ops[:10], "idle_gaps": [list(g) for g in gaps[:10]]}
