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


_LEAF = object()  # a leaf's place in a tree definition


def tree_flatten(tree, is_leaf=None) -> Tuple[List, Any]:
    """(leaves, treedef) in ``jax.tree.flatten``'s order: dict keys sorted
    at every level; ``None`` is an empty subtree, as in JAX; a subtree for
    which ``is_leaf`` is true is one leaf.  The optimizer walks its leaves
    in this order and a checkpoint numbers them so, which is what lets
    either package read the other's checkpoints."""
    if tree is None:
        return [], None
    if isinstance(tree, dict) and not (is_leaf is not None and is_leaf(tree)):
        leaves, defs = [], {}
        for k in sorted(tree):
            sub, defs[k] = tree_flatten(tree[k], is_leaf)
            leaves += sub
        return leaves, defs
    return [tree], _LEAF


def tree_unflatten(treedef, leaves) -> Any:
    """Inverse of ``tree_flatten``: ``leaves`` in its order."""
    it = iter(leaves)

    def build(d):
        if d is _LEAF:
            return next(it)
        if d is None:
            return None
        return {k: build(v) for k, v in d.items()}

    out = build(treedef)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the tree definition has places")
    return out


def tree_leaves(tree) -> List:
    """Leaves in sorted-key order (the order ``jax.tree.flatten`` uses)."""
    return tree_flatten(tree)[0]


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


def resolve_device(device) -> torch.device:
    """The device a run asked for; a CUDA device that is not there raises
    rather than falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' asked for, but no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return dev


def count_params(tree) -> int:
    return sum(int(t.numel()) for t in tree_leaves(tree))
