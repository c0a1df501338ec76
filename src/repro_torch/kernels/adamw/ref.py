"""Plain PyTorch versions of the fused AdamW kernels (``csrc/adamw.cu``):
the reference's per-leaf arithmetic (``src/repro/training/optim.py``,
the clip at :106 and ``_update_leaf`` at :109-130) as separate tensor
ops, each f32 operation in the reference's order.  The CPU runs these;
``chip_smoke.py`` holds the kernels against them on the card.

``scalars`` is the step's (4,) f32 tensor: the clip scale, lr, and the
bias corrections 1 - b1^t and 1 - b2^t.  Sums (the gradient norm, the
factored means) accumulate in f64 and round once to f32, as the kernels'
do: the correctly rounded f32 sum, whatever the order.
"""

from __future__ import annotations

import torch

F32, F64 = torch.float32, torch.float64


def clipped(g, scale):
    """The reference rounds the clipped gradient back to the gradient's
    dtype (bf16 for bf16 parameters) before the update uses it."""
    return (g.to(F32) * scale).to(g.dtype)


def sq_norm_ref(g):
    """The sum of squares of ``g``, a 0-d f64 tensor."""
    return torch.sum(torch.square(g.to(F64)))


def factored_stats_ref(g, vr, vc, denom, scalars, b2: float) -> None:
    """The factored second moment's statistics of the clipped ``g`` (..., R,
    C), in place: vr (..., R) and vc (..., C) take the row and column means
    of g², and ``denom`` (...) becomes max(mean(vc), 1e-30), the rank-1
    reconstruction's divisor."""
    g2 = clipped(g, scalars[0]).to(F64)
    g2 = g2 * g2
    R, C = g.shape[-2:]
    vr.mul_(b2).add_(g2.sum(dim=-1).to(F32) / C * (1 - b2))
    vc.mul_(b2).add_(g2.sum(dim=-2).to(F32) / R * (1 - b2))
    denom.copy_(torch.clamp(vc.to(F64).sum(dim=-1).to(F32) / C, min=1e-30))


def adamw_update_ref(p, g, m, v, vr, vc, denom, scalars, b1: float, b2: float, eps: float, wd: float,
                     decay: bool) -> None:
    """One AdamW step of one leaf, in place: ``p``, ``m`` and ``v`` are
    overwritten (m and p rounded to their dtypes after the f32 math).  With
    ``v`` None the second moment is factored: v̂ = vr ⊗ vc / denom / (1 -
    b2^t) from statistics ``factored_stats_ref`` has already updated.
    ``decay``: decoupled weight decay (the reference's ``p.ndim >= 2``)."""
    scale, lr, bc1, bc2 = scalars.unbind()
    gf = clipped(g, scale).to(F32)
    m_new = m.to(F32) * b1
    m_new += gf * (1 - b1)
    if v is not None:
        g2 = gf * (1 - b2)
        g2 *= gf
        v.mul_(b2).add_(g2)
        del g2
        v_hat = v / bc2
    else:
        # rank-1 reconstruction: vr ⊗ vc / mean(vc)
        v_hat = vr[..., None] * vc[..., None, :]
        v_hat /= denom[..., None, None]
        v_hat /= bc2
    del gf
    upd = m_new / bc1
    m.copy_(m_new)
    del m_new
    v_hat.sqrt_().add_(eps)
    upd /= v_hat
    del v_hat
    if decay:
        upd += wd * p.to(F32)
    upd *= lr
    p.copy_(p.to(F32) - upd)
