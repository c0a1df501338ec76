"""Auto-resuming train loop.

Fault-tolerance contract (the reference's):
  * resume: on start, restore the newest *committed* checkpoint (atomic
    manifest rename — see checkpoint.py) and replay the deterministic data
    stream from that step;
  * periodic checkpoints + pruning;
  * a ``crash_after`` hook lets tests kill the loop mid-run and assert the
    restart reproduces the uninterrupted loss trajectory.

The step is eager: forward and backward through the kernels' plain
versions (the kernels have no backward, and the reference trains through
its plain attention and scans as well), then the in-place AdamW update.

Under a mesh (a ``DeviceMesh`` whose ``model`` size is 1) the step runs
data-parallel: each rank takes its rows of the global batch (the
``BATCH`` spec of ``distributed.sharding``), the gradients and the loss
are mean-reduced (in f32) over the batch axes' groups before
``apply_updates``, and every rank holds the whole parameters and state.
This computes the reference's step under ``with mesh``, whose batch is
constrained over ``(pod, data)``, for a loss that is a mean over equally
many tokens per rank, as the token cross-entropy of ``SyntheticLM``
batches is; moe's balance term is a mean of per-rank terms here, where
the reference's is taken over the global batch.  Tensor parallelism over
``model`` waits for the models' sharding constraints.
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

from ..distributed import sharding as shd
from ..models import api
from ..models.common import resolve_device, tree_flatten, tree_unflatten
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


def require_data_parallel(model: int) -> None:
    """The port's loop runs data-parallel only: a ``model`` axis over 1
    raises."""
    if model > 1:
        raise NotImplementedError(
            f"a model axis of {model}: tensor parallelism, the reference's sharding constraints at the "
            "models' constrain sites (models/common.py:71, models/layers.py), is the port's next slice; "
            "the training loop runs data-parallel, with model 1")


def _batch_rows(mesh, batch):
    """This rank's rows of ``batch`` (a dict of tensors whose dim 0 is the
    global batch) under the ``BATCH`` spec."""
    coord = tuple(mesh.get_coordinate())
    shs = shd.batch_shardings(mesh, batch)
    return {k: v[shs[k].shard_slices(tuple(v.shape))[coord]] for k, v in batch.items()}


def _mean_over(groups, n: int, t):
    """Mean of ``t`` over the ranks of ``groups`` (one after another), in
    f32, rounded once to ``t``'s dtype."""
    acc = t.to(torch.float32)
    for g in groups:
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=g)
    return (acc / torch.full((), n, dtype=torch.float32, device=acc.device)).to(t.dtype)


def make_train_step(cfg, ocfg: optim.OptimizerConfig, mesh=None):
    """(params, opt_state, batch) -> (params, opt_state, metrics): one
    AdamW step on ``api.loss_fn(cfg, plain_kernels=True)``, updating
    ``params`` and ``opt_state`` in place.  ``batch`` holds tensors on the
    parameters' device; the metrics ("loss", "ce", "aux", "grad_norm",
    "lr") are 0-d tensors there.  Under ``mesh`` the step is
    data-parallel: ``batch`` is the global batch, of which this rank
    computes its rows, and the gradients and loss terms are mean-reduced
    over the batch axes."""
    lfn = api.loss_fn(cfg, plain_kernels=True)
    if mesh is not None:
        sizes = shd.axis_sizes(mesh)
        require_data_parallel(sizes.get("model", 1))
        live = [a for a in shd.BATCH if a in sizes]
        groups, n = [mesh.get_group(a) for a in live], math.prod(sizes[a] for a in live)

    def step_fn(params, opt_state, batch):
        if mesh is not None:
            batch = _batch_rows(mesh, batch)
        loss, parts, grads = loss_and_grads(lfn, params, batch)
        if mesh is not None:
            for g in grads:  # in place, one leaf's f32 copy at a time
                g.copy_(_mean_over(groups, n, g))
            loss, parts = _mean_over(groups, n, loss), {k: _mean_over(groups, n, v) for k, v in parts.items()}
        grads = tree_unflatten(tree_flatten(params)[1], grads)
        params, opt_state, om = optim.apply_updates(ocfg, params, grads, opt_state)
        return params, opt_state, {"loss": loss, **parts, **om}

    return step_fn


def default_optimizer(steps: int) -> optim.OptimizerConfig:
    """The loop's optimizer when none is given: the defaults, with the
    schedule fitted to a run of ``steps``."""
    return optim.OptimizerConfig(total_steps=steps, warmup_steps=max(1, min(100, steps // 10)))


def _whole(tree):
    """DTensor leaves gathered whole: the data-parallel step holds every
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
    reference's restore does; ``mesh`` makes the step data-parallel (see
    the module's docstring).  Every rank of the mesh calls ``train``."""
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

    losses: List[float] = []
    for step in range(step0, tcfg.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(step).items()}
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
