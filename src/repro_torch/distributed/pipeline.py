"""GPipe-style pipeline parallelism over a ``stage`` mesh dim, on
``torch.distributed`` (the reference's ``distributed/pipeline.py``).

Layer blocks are split one slice per stage; microbatches stream through a
ring (each rank sends to the next stage and receives from the previous
one with ``batch_isend_irecv``), and the schedule is the standard
(n_micro + n_stages - 1)-step fill/drain.

Every stage runs every step, as in the reference's SPMD formulation:
bubble steps compute on zeros and their results are masked out.  The last
stage's outputs reach every stage through a SUM all-reduce of the masked
buffers (zeros elsewhere), the reference's ``psum``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..models.common import tree_flatten, tree_unflatten
from .sharding import axis_sizes


def gpipe(stage_fn: Callable, mesh, axis: str = "stage"):
    """Build a pipelined apply: ``f(stage_params, xs) -> ys``.

    stage_fn(params_one_stage, x) -> y   (same shape as x)
    stage_params: this rank's slice of a tree with a leading [n_stages] dim
        on every leaf: leading dim 1, the slice at its coordinate on ``axis``
    xs: (n_micro, mb, ...) microbatches, the same on every rank; ys: same
        shape, after all stages, on every rank.
    """
    n_stages = axis_sizes(mesh)[axis]

    def f(stage_params, xs):
        leaves, treedef = tree_flatten(stage_params)
        local = tree_unflatten(treedef, [p[0] for p in leaves])
        group = mesh.get_group(axis)
        idx = mesh.get_local_rank(axis)
        nxt = dist.get_global_rank(group, (idx + 1) % n_stages)
        prev = dist.get_global_rank(group, (idx - 1) % n_stages)
        n_micro = xs.shape[0]
        buf = torch.zeros_like(xs[0])
        outs = torch.zeros_like(xs)
        for t in range(n_micro + n_stages - 1):
            # stage 0 consumes microbatch t (zeros once drained)
            x0 = xs[t] if t < n_micro else torch.zeros_like(xs[0])
            y = stage_fn(local, x0 if idx == 0 else buf)
            # last stage emits microbatch t - (n_stages - 1)
            if idx == n_stages - 1 and t >= n_stages - 1:
                outs[t - (n_stages - 1)] = y
            if n_stages > 1:  # one stage has no ring: a rank cannot send to itself
                buf = torch.empty_like(y)
                for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, y.contiguous(), nxt, group),
                                                   dist.P2POp(dist.irecv, buf, prev, group)]):
                    req.wait()
        # outputs accumulated on the last stage only (zeros elsewhere)
        dist.all_reduce(outs, op=dist.ReduceOp.SUM, group=group)
        return outs

    return f


def pipeline_stage_params(params_stacked, n_stages: int):
    """Check a [L, ...]-stacked block tree splits evenly into stages and
    reshape to [n_stages, L/n_stages, ...] (stage-major)."""

    def leaf(p):
        L = p.shape[0]
        if L % n_stages:
            raise ValueError(f"layers {L} % stages {n_stages} != 0")
        return p.reshape(n_stages, L // n_stages, *p.shape[1:])

    leaves, treedef = tree_flatten(params_stacked)
    return tree_unflatten(treedef, [leaf(p) for p in leaves])
