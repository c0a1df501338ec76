"""Weights made on the device from the seed, in the type they are served
in (bf16), one ``normal_`` or ``fill_`` call per leaf, leaves in sorted
path order, with one ``torch.Generator`` on the device.  The tree's shapes
and each leaf's draw are the architecture module's (``kvbench/arch/``).
The same tensors are handed to the program and, layer by layer upcast, to
the reference.
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict, Iterator, Tuple

import torch


def _leaves(tree: Dict, prefix: str = "") -> Iterator[Tuple[str, Tuple[int, ...]]]:
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def count(arch: ModuleType, model: Dict) -> int:
    n = 0
    for _, shape in _leaves(arch.shapes(model)):
        size = 1
        for s in shape:
            size *= s
        n += size
    return n


def make(arch: ModuleType, model: Dict, seed: int, device) -> Dict:
    """The parameter tree for ``model``, drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    out: Dict = {}
    for path, shape in _leaves(arch.shapes(model)):
        t = torch.empty(shape, dtype=torch.bfloat16, device=device)
        how, value = arch.init(path.rsplit(".", 1)[-1], shape)
        if how == "fill":
            t.fill_(value)
        elif how == "normal":
            t.normal_(0.0, value, generator=gen)
        else:
            raise ValueError(f"{path}: no draw {how!r}")
        node = out
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return out
