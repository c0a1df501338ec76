"""In-repo optimizer: AdamW with production memory knobs, as the
reference's ``training/optim.py`` computes it.

Two options (the ones the 1T-param kimi-k2 config uses):

  * ``moment_dtype`` — store the first moment in bf16; the f32 math
    happens per leaf, per step.
  * ``factored_second_moment`` — Adafactor-style row/col factorization of v
    for >=2-D parameters: O(n+m) state instead of O(n*m).

Every computation is in f32 tensors in the reference's order of
operations.  The reference is functional; here ``params``, ``m`` and ``v``
are updated in place, leaf by leaf, under ``torch.no_grad()``, so a second
copy of parameters and state is never alive and the f32 temporaries stay
bounded by the largest leaf.

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
    return torch.sqrt(sum(torch.sum(torch.square(g.to(F32))) for g in tree_flatten(tree)[0]))


def _clip_scale(nrm, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(nrm, min=1e-9), max=1.0)


def _clipped(g, scale):
    """The reference rounds the clipped gradient back to the gradient's
    dtype (bf16 for bf16 parameters) before the update uses it."""
    return (g.to(F32) * scale).to(g.dtype)


def clip_by_global_norm(grads, max_norm: float):
    nrm = global_norm(grads)
    scale = _clip_scale(nrm, max_norm)
    return _map(lambda g: _clipped(g, scale), grads), nrm


@torch.no_grad()
def _update_leaf(cfg: OptimizerConfig, lr, t, p, g, m, v):
    """One AdamW step of one leaf, in place: ``p``, ``m`` and the tensors
    of ``v`` are overwritten (m rounded to its dtype after the f32 math).
    Returns (p, m, v)."""
    b1, b2 = cfg.betas
    gf = g.to(F32)
    m_new = m.to(F32) * b1
    m_new += gf * (1 - b1)
    if "v" in v:
        g2 = gf * (1 - b2)
        g2 *= gf
        v["v"].mul_(b2).add_(g2)
        del g2
        v_hat = v["v"] / (1 - b2**t)
    else:
        g2 = gf * gf
        vr, vc = v["vr"], v["vc"]
        vr.mul_(b2).add_(g2.sum(dim=-1) / g2.shape[-1] * (1 - b2))
        vc.mul_(b2).add_(g2.sum(dim=-2) / g2.shape[-2] * (1 - b2))
        del g2
        # rank-1 reconstruction: vr ⊗ vc / mean(vc)
        denom = torch.clamp(vc.sum(dim=-1, keepdim=True) / vc.shape[-1], min=1e-30)
        v_hat = vr[..., None] * vc[..., None, :]
        v_hat /= denom[..., None]
        v_hat /= 1 - b2**t
    del gf
    upd = m_new / (1 - b1**t)
    m.copy_(m_new)
    del m_new
    v_hat.sqrt_().add_(cfg.eps)
    upd /= v_hat
    del v_hat
    if p.ndim >= 2:  # decoupled weight decay on matrices only
        upd += cfg.weight_decay * p.to(F32)
    upd *= lr
    p.copy_(p.to(F32) - upd)
    return p, m, v


@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, params, grads, state):
    """One AdamW step, in place on ``params`` and ``state``.  Returns
    (params, state, {"grad_norm", "lr"}) with the same objects."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state["step"] + 1
    t = step.to(F32)
    lr = lr_schedule(cfg, step)

    flat_p = tree_flatten(params)[0]
    flat_g = tree_flatten(grads)[0]
    flat_m = tree_flatten(state["m"])[0]
    # v leaves are dicts; flatten at the dict level
    flat_v = tree_flatten(state["v"], is_leaf=lambda x: isinstance(x, dict) and ("v" in x or "vr" in x))[0]
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("params, grads and optimizer state have different trees")
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        _update_leaf(cfg, lr, t, p, _clipped(g, scale), m, v)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}

