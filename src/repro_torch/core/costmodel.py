"""Analytic LSM I/O cost model (paper §2.2 / §3.3).

Costs are expressed in expected block I/Os per operation:

  update       W(T, K) = T·L / (B·K)          (amortized, out-of-place)
  point hit    R(T, K) = K·L·p + 1
  point miss   Z(T, K) = K·L·p                (Bloom-pruned empty probe)
  range scan   S(T, K) = K·L + d/B            (seek every run + stream d)

with L = ceil(log_T(N·e / M)) levels, B entries per block, p the Bloom
false-positive rate.  The adaptive controller minimizes the workload-
weighted sum  w·W + s·S + r·R + z·Z  over the (T, K) design space.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass
class TreeShape:
    n_entries: int  # N
    entry_bytes: int  # e
    buffer_bytes: int  # M
    block_bytes: int = 4096
    bloom_fpr: float = 0.01  # p

    @property
    def entries_per_block(self) -> float:
        return max(1.0, self.block_bytes / max(1, self.entry_bytes))

    def levels(self, T: int) -> int:
        data = max(1, self.n_entries * self.entry_bytes)
        if data <= self.buffer_bytes:
            return 1
        return max(1, math.ceil(math.log(data / self.buffer_bytes, T)))


def cost_terms(shape: TreeShape, T: int, K: int, avg_range_entries: float = 8.0):
    L = shape.levels(T)
    B = shape.entries_per_block
    p = shape.bloom_fpr
    W = T * L / (B * K)
    R = K * L * p + 1.0
    Z = K * L * p
    S = K * L + avg_range_entries / B
    return {"W": W, "R": R, "Z": Z, "S": S, "L": L}


def weighted_cost(shape: TreeShape, T: int, K: int, w: float, s: float, r: float, z: float,
                  avg_range_entries: float = 8.0) -> float:
    t = cost_terms(shape, T, K, avg_range_entries)
    return w * t["W"] + s * t["S"] + r * t["R"] + z * t["Z"]


def optimize(shape: TreeShape, w: float, s: float, r: float, z: float,
             t_max: int = 16, avg_range_entries: float = 8.0):
    """Enumerate the (T, K) design space (paper §3.3: 'iterating over
    different values of the size ratio T and the runs parameter K')."""
    total = max(1e-12, w + s + r + z)
    w, s, r, z = w / total, s / total, r / total, z / total
    best = None
    for T in range(2, t_max + 1):
        for K in range(1, T):  # K=1 leveling ... K=T-1 tiering
            c = weighted_cost(shape, T, K, w, s, r, z, avg_range_entries)
            if best is None or c < best[0]:
                best = (c, T, K)
    return {"cost": best[0], "T": best[1], "K": best[2]}
