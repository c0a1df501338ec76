"""Parameters from numpy: the reference's parameter tree, exported leaf by
leaf as numpy arrays, becomes the port's parameters under the same keys.

Stacked ``blocks`` keep their leading L axis.  numpy has no bfloat16 of its
own, so a bf16 leaf arrives as its ``np.int16`` bit view and is viewed back
as ``torch.bfloat16`` after ``torch.from_numpy``.  Other dtypes (float32
leaves) keep theirs.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def from_numpy_leaf(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if not a.flags.writeable or not a.flags.c_contiguous:
        a = np.array(a, order="C")  # torch.from_numpy wants a writeable, C-ordered buffer
    t = torch.from_numpy(a)
    if t.dtype == torch.int16:
        t = t.view(torch.bfloat16)
    return t.to(device)


def from_numpy_tree(tree, device="cuda") -> Dict:
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    return from_numpy_leaf(tree, device)
