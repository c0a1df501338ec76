"""Auto-resuming train loop.

Fault-tolerance contract (the reference's):
  * resume: on start, restore the newest *committed* checkpoint (atomic
    manifest rename — see checkpoint.py) and replay the deterministic data
    stream from that step;
  * periodic checkpoints + pruning;
  * a ``crash_after`` hook lets tests kill the loop mid-run and assert the
    restart reproduces the uninterrupted loss trajectory.

The step: forward and backward through the kernels' plain versions (the
kernels have no backward, and the reference trains through its plain
attention and scans as well), then the in-place AdamW update, one fused
kernel a leaf (``kernels/adamw``).  The reference jits the step; without
a mesh, ``train`` captures it on a CUDA device as one CUDA graph
(``graphs.capture``, its first two steps the warm calls), and every later
step replays it.

Under a mesh (a ``DeviceMesh`` over (pod,) data and model) the step
computes the reference's step under ``with mesh``, and every rank holds
the whole parameters and optimizer state, as the reference's launcher
(which computes the parameter shardings and never uses them) does:
  * over the batch axes, data-parallel: each rank takes its rows of the
    global batch (the ``BATCH`` spec of ``distributed.sharding``), and the
    gradients and loss terms are mean-reduced (in f32) over the batch
    axes' groups, which is the global batch's for a loss that is a mean
    over equally many tokens per rank, as the token cross-entropy of
    ``SyntheticLM`` batches is.  moe's balance term is built on the mean
    of the router's probabilities over the global batch
    (``models.common.mean_over_batch``), as the reference's is;
  * over ``model``, tensor-parallel: the forward and backward run under
    ``models.common.tensor_parallel(mesh)``, each model rank computing its
    part of the splits at the reference's constrain sites, and before the
    mean over the batch axes the gradients that the splits leave partial
    (``sharding.model_partial``) are summed over ``model``
    (``reduce_grads``).
The step stays eager under a mesh: its collectives run over gloo ranks
(the multi-rank paths; NCCL takes one rank a card), which a CUDA graph
cannot hold.
"""

from __future__ import annotations

import math
import os
import tempfile
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .. import graphs
from ..distributed import sharding as shd
from ..models import api
from ..models.common import MODEL_AXIS, resolve_device, tensor_parallel, tree_flatten, tree_unflatten
from . import checkpoint as ckpt
from . import optim
from .data import DataConfig, SyntheticLM


@dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    keep: int = 3
    log_every: int = 10
    seed: int = 0


def loss_and_grads(lfn, params, batch):
    """``lfn(params, batch)`` -> (loss, parts), differentiated: returns
    (loss, parts, grads), the gradients of every parameter leaf in
    ``tree_flatten`` order.  The leaves require grad only for the call."""
    leaves = tree_flatten(params)[0]
    for leaf in leaves:
        leaf.requires_grad_(True)
    try:
        loss, parts = lfn(params, batch)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for leaf in leaves:
            leaf.requires_grad_(False)
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, list(grads)


def _batch_rows(mesh, batch):
    """This rank's rows of ``batch`` (a dict of tensors whose dim 0 is the
    global batch) under the ``BATCH`` spec."""
    coord = tuple(mesh.get_coordinate())
    shs = shd.batch_shardings(mesh, batch)
    return {k: v[shs[k].shard_slices(tuple(v.shape))[coord]] for k, v in batch.items()}


def _batch_groups(mesh):
    """The groups of the batch axes over 1 and the product of their sizes
    (an axis of size 1 has nothing to reduce: on CUDA tensors gloo would
    still stage each leaf through host memory and back)."""
    sizes = shd.axis_sizes(mesh)
    live = [a for a in shd.BATCH if sizes.get(a, 1) > 1]
    return [mesh.get_group(a) for a in live], math.prod(sizes[a] for a in live)


def _mean_over(groups, n: int, t, model_group=None):
    """Mean of ``t`` over the ranks of ``groups`` (one after another),
    summed first over ``model_group`` when one is given, in f32, rounded
    once to ``t``'s dtype."""
    acc = t.to(torch.float32)
    for g in ([model_group] if model_group is not None else []) + groups:
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=g)
    return acc.div_(torch.full((), n, dtype=torch.float32, device=acc.device)).to(t.dtype)


def reduce_grads(mesh, partial, grads) -> None:
    """In place, leaf by leaf (one f32 copy at a time): the gradients that
    tensor parallelism leaves partial (``partial``, a flag per leaf from
    ``sharding.model_partial_leaves``) summed over ``model``, then every
    gradient mean-reduced over the batch axes.

    A balance term built on ``models.common.mean_over_batch`` counts once
    in this mean, not twice and not 1/n times: its gradient reaches rank
    r's ``me_r`` through the mean's backward, which sums over the n batch
    ranks the gradient each of them holds, g/n, so rank r holds g, the
    gradient of the term with respect to the global mean; the mean here
    then takes (1/n)·Σ_r g·∂me_r/∂θ = g·∂(mean_r me_r)/∂θ, the gradient
    of the reference's term over the global batch."""
    groups, n = _batch_groups(mesh)
    model = mesh.get_group(MODEL_AXIS) if shd.axis_sizes(mesh).get(MODEL_AXIS, 1) > 1 else None
    for g, part in zip(grads, partial):
        g.copy_(_mean_over(groups, n, g, model if part else None))


def make_grad_fn(cfg, mesh=None):
    """(params, batch) -> (loss, parts, grads): the train step's forward
    and backward through ``api.loss_fn(cfg, plain_kernels=True)``, the
    gradients a list in ``tree_flatten`` order.  Under ``mesh``, ``batch``
    is the global batch, this rank computes its rows under
    ``tensor_parallel(mesh)``, and the gradients (``reduce_grads``) and the
    loss terms (mean over the batch axes) are the whole step's on every
    rank."""
    lfn = api.loss_fn(cfg, plain_kernels=True)
    if mesh is None:
        return lambda params, batch: loss_and_grads(lfn, params, batch)
    partial = shd.model_partial_leaves(api.param_specs(cfg))
    groups, n = _batch_groups(mesh)

    def grad_fn(params, batch):
        with tensor_parallel(mesh):
            loss, parts, grads = loss_and_grads(lfn, params, _batch_rows(mesh, batch))
        reduce_grads(mesh, partial, grads)
        return _mean_over(groups, n, loss), {k: _mean_over(groups, n, v) for k, v in parts.items()}, grads

    return grad_fn


def make_train_step(cfg, ocfg: optim.OptimizerConfig, mesh=None):
    """(params, opt_state, batch) -> (params, opt_state, metrics): one
    AdamW step on the gradients of ``make_grad_fn(cfg, mesh)``, updating
    ``params`` and ``opt_state`` in place.  ``batch`` holds tensors on the
    parameters' device; the metrics ("loss", "ce", "aux", "grad_norm",
    "lr") are 0-d tensors there.  Every tensor of ``params`` and
    ``opt_state`` is updated in place and nothing reads the host, so on a
    CUDA device the step captures as one CUDA graph (``graphs.capture``
    with ``held=(0, 1)``).  Under ``mesh`` the step is data- and
    tensor-parallel (see the module's docstring): ``batch`` is the global
    batch, and every rank ends the step with the same parameters."""
    grad_fn = make_grad_fn(cfg, mesh)

    def step_fn(params, opt_state, batch):
        loss, parts, grads = grad_fn(params, batch)
        grads = tree_unflatten(tree_flatten(params)[1], grads)
        params, opt_state, om = optim.apply_updates(ocfg, params, grads, opt_state)
        return params, opt_state, {"loss": loss, **parts, **om}

    return step_fn


def default_optimizer(steps: int) -> optim.OptimizerConfig:
    """The loop's optimizer when none is given: the defaults, with the
    schedule fitted to a run of ``steps``."""
    return optim.OptimizerConfig(total_steps=steps, warmup_steps=max(1, min(100, steps // 10)))


def _whole(tree):
    """DTensor leaves gathered whole: the step under a mesh holds every
    parameter and moment whole on each rank."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [t.full_tensor() if isinstance(t, DTensor) else t for t in leaves])


def train(
    model_cfg,
    tcfg: TrainConfig,
    ocfg: Optional[optim.OptimizerConfig] = None,
    shardings=None,
    crash_after: Optional[int] = None,
    log: Callable[[str], None] = print,
    device="cuda",
    mesh=None,
) -> Dict:
    """Run (or resume) training on ``device``.  Returns {step, losses,
    resumed_from, crashed}.  ``shardings`` (a tree like {"params",
    "opt"} of ``NamedSharding``) places a restored checkpoint, as the
    reference's restore does; ``mesh`` makes the step data- and
    tensor-parallel (see the module's docstring).  Every rank of the mesh calls ``train``.

    Without a mesh the step is captured (``graphs.capture(...,
    warm_on_calls=True)``) after the restore, holding the parameters and
    optimizer state: on a CUDA device the loop's first two steps run
    eagerly as the warm calls, each on its own batch, and every later step
    replays the graph; on the CPU every step runs the step itself."""
    dev = resolve_device(device)
    ocfg = ocfg or default_optimizer(tcfg.steps)
    data = SyntheticLM(
        DataConfig(model_cfg.vocab_size, seq_len=128, global_batch=8, seed=tcfg.seed)
    )
    step_fn = make_train_step(model_cfg, ocfg, mesh)

    start = ckpt.latest_step(tcfg.ckpt_dir)
    if start is not None:
        like = {"params": api.init_params(model_cfg, tcfg.seed, dev), "opt": None}
        like["opt"] = optim.init_state(ocfg, like["params"])
        state, manifest = ckpt.restore(tcfg.ckpt_dir, start, like, shardings, dev)
        del like
        state = _whole(state)
        params, opt_state = state["params"], state["opt"]
        step0 = start
        log(f"[train] resumed from step {start}")
    else:
        params = api.init_params(model_cfg, tcfg.seed, dev)
        opt_state = optim.init_state(ocfg, params)
        step0 = 0

    def batch_at(step):
        return {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(step).items()}

    if mesh is None:
        step_fn = graphs.capture(step_fn, params, opt_state, batch_at(step0), held=(0, 1), warm_on_calls=True)
    losses: List[float] = []
    for step in range(step0, tcfg.steps):
        batch = batch_at(step)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if (step + 1) % tcfg.log_every == 0 or step == step0:
            log(f"[train] step {step + 1} loss {float(metrics['loss']):.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f}")
        losses.append(float(metrics["loss"]))
        if (step + 1) % tcfg.ckpt_every == 0 or step + 1 == tcfg.steps:
            ckpt.save(tcfg.ckpt_dir, step + 1, {"params": params, "opt": opt_state})
            ckpt.prune(tcfg.ckpt_dir, tcfg.keep)
        if crash_after is not None and step + 1 >= crash_after:
            return {"step": step + 1, "losses": losses, "resumed_from": step0, "crashed": True}
    return {"step": tcfg.steps, "losses": losses, "resumed_from": step0, "crashed": False}
