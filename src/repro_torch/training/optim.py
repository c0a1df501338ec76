"""In-repo optimizer: AdamW with production memory knobs, as the
reference's ``training/optim.py`` computes it.

Two options (the ones the 1T-param kimi-k2 config uses):

  * ``moment_dtype`` — store the first moment in bf16; the f32 math
    happens per leaf, per step.
  * ``factored_second_moment`` — Adafactor-style row/col factorization of v
    for >=2-D parameters: O(n+m) state instead of O(n*m).

Every element's computation is in f32 in the reference's order of
operations, fused into one op a leaf (``kernels/adamw``: a hand-written
CUDA kernel on the card, its plain version on the CPU; the reference's
XLA fuses the same step).  The reference is functional; here ``params``,
``m``, ``v`` and ``step`` are updated in place, leaf by leaf, under
``torch.no_grad()``, so a second copy of parameters and state is never
alive, no f32 copy of a leaf is made on the card, and a captured step
replays.

Quirks kept from the reference: clipped gradients are rounded back to the
gradient's dtype before the update; bias corrections are ``b**t`` with
``t`` an f32 tensor; weight decay applies to every leaf with ``ndim >= 2``
and ``_is_factored`` looks only at the last two dims, so the stacked
``(L, D)`` norm scales of the blocks are decayed and (for L >= 2)
factored, vr ``(L,)`` and vc ``(D,)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from ..kernels import adamw
from ..kernels.adamw.ref import clipped
from ..models.common import tree_flatten, tree_unflatten

F32 = torch.float32


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    moment_dtype: str = "float32"  # float32 | bfloat16
    factored_second_moment: bool = False


def lr_schedule(cfg: OptimizerConfig, step):
    """Linear warmup + cosine decay to ``min_lr_frac``; ``step`` an integer
    tensor, the result a 0-d f32 tensor on its device."""
    step = step.to(F32)
    warm = cfg.lr * step / max(1.0, cfg.warmup_steps)
    prog = torch.clamp((step - cfg.warmup_steps) / max(1.0, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def _is_factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 2 and shape[-2] >= 2


def _map(fn, tree):
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(p) for p in leaves])


def init_state(cfg: OptimizerConfig, params) -> Dict:
    """Zero moments on each parameter's device; ``step`` a 0-d int32."""
    mdt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else F32

    def leaf_m(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)

    def leaf_v(p):
        if cfg.factored_second_moment and _is_factored(p.shape):
            return {
                "vr": torch.zeros(p.shape[:-1], dtype=F32, device=p.device),  # row stat (mean over last dim)
                "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=F32, device=p.device),  # col stat
            }
        return {"v": torch.zeros(p.shape, dtype=F32, device=p.device)}

    device = tree_flatten(params)[0][0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": _map(leaf_m, params),
        "v": _map(leaf_v, params),
    }


def state_specs(cfg: OptimizerConfig, param_specs) -> Dict:
    """Meta-tensor tree mirroring ``init_state`` (the dry-run path):
    ``init_state`` on the meta-tensor ``param_specs``."""
    return init_state(cfg, param_specs)


def global_norm(tree):
    """sqrt of the sum of every leaf's squares: each leaf's sum in f64
    (``kernels.adamw.sq_norms``, one op a leaf), their sum rounded once to
    f32."""
    return torch.sqrt(adamw.sq_norms(tree_flatten(tree)[0]).sum().to(F32))


def _clip_scale(nrm, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(nrm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    nrm = global_norm(grads)
    scale = _clip_scale(nrm, max_norm)
    return _map(lambda g: clipped(g, scale), grads), nrm


@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, params, grads, state):
    """One AdamW step, in place on ``params`` and ``state``.  Returns
    (params, state, {"grad_norm", "lr"}) with the same objects.

    Every tensor of ``state`` is updated in place, ``state["step"]``
    included, and the clip scale, lr and bias corrections are computed on
    the step's device from it, so a step captured as a CUDA graph replays
    correctly.  Per leaf: one ``sq_norm`` for the global norm, then (for a
    factored v) one ``factored_stats`` and one ``adamw_update``: the
    kernels of ``kernels.adamw`` on a CUDA device, their plain versions
    on the CPU."""
    flat_p = tree_flatten(params)[0]
    flat_g = tree_flatten(grads)[0]
    flat_m = tree_flatten(state["m"])[0]
    # v leaves are dicts; flatten at the dict level
    flat_v = tree_flatten(state["v"], is_leaf=lambda x: isinstance(x, dict) and ("v" in x or "vr" in x))[0]
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("params, grads and optimizer state have different trees")
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state["step"]
    step.add_(1)
    t = step.to(F32)
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.betas
    scalars = torch.stack([scale, lr, 1 - b1**t, 1 - b2**t])
    hyper = dict(b1=b1, b2=b2, eps=cfg.eps, weight_decay=cfg.weight_decay)
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        if "v" in v:
            adamw.adamw_update(p, g, m, v["v"], scalars, **hyper)
        else:
            denom = adamw.factored_stats(g, v["vr"], v["vc"], scalars, b2)
            adamw.adamw_update(p, g, m, None, scalars, vr=v["vr"], vc=v["vc"], denom=denom, **hyper)
    return params, state, {"grad_norm": gnorm, "lr": lr}
