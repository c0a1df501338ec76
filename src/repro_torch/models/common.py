"""Parameter-spec trees and their materialisation on an explicit device.

A nested dict of ``Spec`` leaves is the single source of truth for a
model's parameters; ``tree_init`` turns it into a dict of tensors with the
reference's init schemes.  The reference's sharding hooks (``constrain``,
mesh helpers) have no counterpart: the port runs on one device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class Spec:
    """Declarative parameter leaf: shape + dtype + init scheme."""

    shape: Tuple[int, ...]
    dtype: Any = torch.bfloat16
    init: str = "normal"  # normal | zeros | ones | small
    scale: float = 1.0


def tree_leaves(tree) -> List:
    """Leaves in sorted-key order (the order ``jax.tree.flatten`` uses)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def init_leaf(s: Spec, device, seed: int) -> torch.Tensor:
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=s.dtype, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=s.dtype, device=device)
    fan_in = s.shape[-2] if len(s.shape) >= 2 else max(1, s.shape[-1])
    std = s.scale / np.sqrt(fan_in)
    if s.init == "small":
        std *= 0.1
    gen = _generator(device, seed)
    out = torch.empty(s.shape, dtype=s.dtype, device=device)
    # a stacked leaf is drawn one layer at a time: the f32 draw of a whole
    # (L, D, F) stack would need twice the bf16 result's memory again
    rows = out if len(s.shape) >= 3 else out[None]
    for r in rows:
        r.copy_(torch.randn(r.shape, generator=gen, dtype=torch.float32, device=device) * std)
    return out


def tree_init(template, seed: int = 0, device="cuda") -> Dict:
    """Spec tree -> dict of tensors on ``device``.  Leaf i (in sorted-key
    order) is drawn from a generator seeded with ``seed * 1_000_003 + i``.
    The numbers differ from JAX's for the same seed; tests that compare
    the two packages convert JAX's params (``models.convert``)."""
    counter = iter(range(len(tree_leaves(template))))

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(tree[k]) for k in sorted(tree)}
        return init_leaf(tree, device, seed * 1_000_003 + next(counter))

    return build(template)


def count_params(tree) -> int:
    return sum(int(t.numel()) for t in tree_leaves(tree))
