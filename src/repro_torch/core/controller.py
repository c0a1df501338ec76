"""Adaptive controller (paper §3.3): sliding-window workload monitoring +
threshold-triggered (T, K) re-optimization with lazy adoption.

Operation classes map to the paper's coefficients:
  w — put_batch index inserts (writes)
  s — get_batch range scans
  r — probe point lookups that found an entry
  z — probe point lookups that found nothing (Bloom-pruned empty probes)
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Optional

from .costmodel import TreeShape, optimize

OP_WRITE = "w"
OP_RANGE = "s"
OP_READ = "r"
OP_EMPTY = "z"
_OPS = (OP_WRITE, OP_RANGE, OP_READ, OP_EMPTY)


@dataclass
class TuningEvent:
    op_count: int
    mix: dict
    T: int
    K: int
    predicted_cost: float


@dataclass
class AdaptiveController:
    """Observes the operation stream and retunes the LSM when the workload
    mix drifts (threshold detection à la CAMAL)."""

    lsm: object  # LSMTree (duck-typed: set_targets, buffer_bytes, n_entries)
    window: int = 4096
    threshold: float = 0.15  # L1 distance on the op-mix simplex
    min_ops_between_tunings: int = 512
    entry_bytes: int = 64
    avg_range_entries: float = 8.0
    t_max: int = 16
    enabled: bool = True
    _ops: Deque = field(default_factory=deque)
    _counts: dict = field(default_factory=lambda: {o: 0 for o in _OPS})
    _last_mix: Optional[dict] = None
    _since_tune: int = 0
    history: list = field(default_factory=list)

    def record(self, op: str, n: int = 1) -> None:
        if op not in self._counts:
            raise ValueError(f"unknown op class {op!r}")
        for _ in range(min(n, self.window)):
            self._ops.append(op)
            self._counts[op] += 1
            if len(self._ops) > self.window:
                old = self._ops.popleft()
                self._counts[old] -= 1
        self._since_tune += n
        if self.enabled and self._since_tune >= self.min_ops_between_tunings:
            if self._drifted():
                self.tune()

    def mix(self) -> dict:
        total = max(1, sum(self._counts.values()))
        return {o: self._counts[o] / total for o in _OPS}

    def _drifted(self) -> bool:
        if sum(self._counts.values()) < self.window // 4:
            return False
        if self._last_mix is None:
            return True
        cur = self.mix()
        l1 = sum(abs(cur[o] - self._last_mix[o]) for o in _OPS)
        return l1 > self.threshold

    def tune(self) -> Optional[TuningEvent]:
        """Re-optimize (T, K) from the current window and hand the targets to
        the LSM for lazy adoption."""
        cur = self.mix()
        shape = TreeShape(
            n_entries=max(1, self.lsm.n_entries),
            entry_bytes=self.entry_bytes,
            buffer_bytes=self.lsm.buffer_bytes,
        )
        best = optimize(
            shape,
            w=cur[OP_WRITE],
            s=cur[OP_RANGE],
            r=cur[OP_READ],
            z=cur[OP_EMPTY],
            t_max=self.t_max,
            avg_range_entries=self.avg_range_entries,
        )
        self.lsm.set_targets(best["T"], best["K"])
        self._last_mix = cur
        self._since_tune = 0
        ev = TuningEvent(
            op_count=sum(self._counts.values()),
            mix=cur,
            T=best["T"],
            K=best["K"],
            predicted_cost=best["cost"],
        )
        self.history.append(ev)
        return ev
