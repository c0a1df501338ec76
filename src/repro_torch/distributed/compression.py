"""Error-feedback int8 gradient compression for the data-parallel axis,
on ``torch.distributed`` (the reference's ``distributed/compression.py``).

At 1000+-node scale the DP gradient all-reduce crosses the slowest links;
int8 compression cuts those bytes 4x vs f32 (2x vs bf16).  Error feedback
keeps the quantization noise unbiased over steps:

    e_t      accumulated residual (f32, shaped like the grad)
    g'_t     = g_t + e_t
    q_t      = int8(g'_t)  per-tensor scale
    e_{t+1}  = g'_t - dequant(q_t)
    update   uses mean_dp(dequant(q_t))

Every computation is in f32 in the reference's order of operations;
``torch.round`` rounds half to even, as ``jnp.round`` does.  Divisors are
device tensors: PyTorch's CUDA division by a Python scalar multiplies by
its reciprocal, which can differ from a true division in the last bit.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed as dist

from ..models.common import tree_flatten, tree_unflatten
from .sharding import BATCH, axis_sizes

F32 = torch.float32


def _scalar(x: float, like) -> torch.Tensor:
    return torch.full((), x, dtype=F32, device=like.device)


def quantize_tensor(g) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 q, 0-d f32 scale): scale = max(|g|, 1e-30) / 127, q =
    clip(round(g / scale), ±127)."""
    gf = g.to(F32)
    scale = torch.clamp(gf.abs().max(), min=1e-30) / _scalar(127.0, gf)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_tensor(q, scale):
    return q.to(F32) * scale


def compress_grads(grads, residuals):
    """Error-feedback quantization. Returns (q_tree, scale_tree, new_residuals)."""

    def leaf(g, e):
        gf = g.to(F32) + e
        q, s = quantize_tensor(gf)
        return q, s, gf - dequantize_tensor(q, s)

    flat, treedef = tree_flatten(grads)
    eflat = tree_flatten(residuals)[0]
    qs, ss, es = zip(*(leaf(g, e) for g, e in zip(flat, eflat)))
    return tree_unflatten(treedef, qs), tree_unflatten(treedef, ss), tree_unflatten(treedef, es)


def init_residuals(params):
    leaves, treedef = tree_flatten(params)
    return tree_unflatten(treedef, [torch.zeros(p.shape, dtype=F32, device=p.device) for p in leaves])


def _live(mesh, axes):
    sizes = axis_sizes(mesh)
    return [a for a in axes if a in sizes], sizes


def allreduce_quantized(mesh, q_tree, s_tree, axes=BATCH):
    """Mean over the ranks of the named mesh dims of dequant(q, s), leaf by
    leaf, with max-scale requantization: all ranks agree on s_max (a MAX
    all-reduce of the scalar), rescale their int payload to it (values stay
    <= 127), and SUM-all-reduce the ints as int32; the result is qsum ·
    s_max / n.  (Mean-of-scales x mean-of-ints is NOT the mean of products:
    the reference measured a 13 % error.)  Over several mesh dims the
    reductions run one dim's group after another: MAX and an integer SUM
    give the same result in any order."""
    live, sizes = _live(mesh, axes)
    groups = [mesh.get_group(a) for a in live]
    n = math.prod(sizes[a] for a in live)

    def reduce_leaf(q, s):
        s_max = s.clone()
        for g in groups:
            dist.all_reduce(s_max, op=dist.ReduceOp.MAX, group=g)
        qr = torch.round(q.to(F32) * (s / s_max))
        qsum = qr.to(torch.int32)
        for g in groups:
            dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=g)
        return qsum.to(F32) * (s_max / _scalar(n, s_max))

    q_flat, treedef = tree_flatten(q_tree)
    s_flat = tree_flatten(s_tree)[0]
    return tree_unflatten(treedef, [reduce_leaf(q, s) for q, s in zip(q_flat, s_flat)])


def allreduce_compressed(mesh, grads, residuals, axes=BATCH):
    """Mean-all-reduce grads over the mesh dims ``axes`` with int8 error
    feedback -> (reduced grads, new residuals).

    Each leaf is quantized against (grad + residual) and reduced by
    ``allreduce_quantized`` — the wire carries the int payload (widened to
    int32 for the sum) + one f32 scale per leaf.  With none of ``axes`` on
    the mesh the inputs come back as they are.
    """
    live, _ = _live(mesh, axes)
    if not live:
        return grads, residuals
    q_tree, s_tree, new_res = compress_grads(grads, residuals)
    return allreduce_quantized(mesh, q_tree, s_tree, live), new_res
