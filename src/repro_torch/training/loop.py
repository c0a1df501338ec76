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
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

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


def make_train_step(cfg, ocfg: optim.OptimizerConfig):
    """(params, opt_state, batch) -> (params, opt_state, metrics): one
    AdamW step on ``api.loss_fn(cfg, plain_kernels=True)``, updating
    ``params`` and ``opt_state`` in place.  ``batch`` holds tensors on the
    parameters' device; the metrics ("loss", "ce", "aux", "grad_norm",
    "lr") are 0-d tensors there."""
    lfn = api.loss_fn(cfg, plain_kernels=True)

    def step_fn(params, opt_state, batch):
        loss, parts, grads = loss_and_grads(lfn, params, batch)
        grads = tree_unflatten(tree_flatten(params)[1], grads)
        params, opt_state, om = optim.apply_updates(ocfg, params, grads, opt_state)
        return params, opt_state, {"loss": loss, **parts, **om}

    return step_fn


def default_optimizer(steps: int) -> optim.OptimizerConfig:
    """The loop's optimizer when none is given: the defaults, with the
    schedule fitted to a run of ``steps``."""
    return optim.OptimizerConfig(total_steps=steps, warmup_steps=max(1, min(100, steps // 10)))


def train(
    model_cfg,
    tcfg: TrainConfig,
    ocfg: Optional[optim.OptimizerConfig] = None,
    crash_after: Optional[int] = None,
    log: Callable[[str], None] = print,
    device="cuda",
) -> Dict:
    """Run (or resume) training on ``device``.  Returns {step, losses,
    resumed_from, crashed}."""
    dev = resolve_device(device)
    ocfg = ocfg or default_optimizer(tcfg.steps)
    data = SyntheticLM(
        DataConfig(model_cfg.vocab_size, seq_len=128, global_batch=8, seed=tcfg.seed)
    )
    step_fn = make_train_step(model_cfg, ocfg)

    start = ckpt.latest_step(tcfg.ckpt_dir)
    if start is not None:
        like = {"params": api.init_params(model_cfg, tcfg.seed, dev), "opt": None}
        like["opt"] = optim.init_state(ocfg, like["params"])
        state, manifest = ckpt.restore(tcfg.ckpt_dir, start, like, dev)
        del like
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
