"""The plain reference of a dense GQA decoder: plain PyTorch, float32, no
kernel, no cache, no batching across requests beyond a stacked batch of
equal-length prompts.  It imports nothing of the program.

It follows the configuration file as run (``kvbench/configs/<config>.json``,
its ``model`` object) and the weights' layout of
``kvbench/arch/dense_gqa.py``: a pre-norm decoder block (RMSNorm, GQA
attention with RoPE on the two halves of each head, optional QK-norm and
q/k/v bias, SwiGLU MLP), untied embedding and output head.

``precision="fp8"`` is the control: every matrix product's operands are
rounded to float8 e4m3 (weights by output channel, activations by row,
each scaled to the format's range) before an f32 product.  That is the
lower precision a later change would be tempted by; it has to fail the
cell's limits.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence

import torch

F32 = torch.float32
FP8_MAX = 448.0  # largest finite float8 e4m3fn


@contextlib.contextmanager
def exact_f32():
    """f32 products in f32: TF32 off for matmul and cuDNN while inside."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``'s
    complement (the absmax over ``dim`` maps to the format's max)."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(F32) * s


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x (..., K) @ w (K, N) in f32, or with fp8-rounded operands."""
    w = w.to(F32)
    if precision == "fp8":
        x = fp8_round(x, -1)  # a scale per row
        w = fp8_round(w, 0)  # a scale per output channel
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.to(F32)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D): the first and second halves of each head rotated as pairs."""
    D = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float64, device=x.device) / D))
    ang = (positions.to(torch.float64)[:, None] * freqs).to(F32)
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over keys at or before each query, in f32,
    a block of query rows at a time.  q (B, S, H, D), k and v (B, S, KVH, D)."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    kh = k.repeat_interleave(G, dim=2).permute(0, 2, 3, 1)  # (B, H, D, S)
    vh = v.repeat_interleave(G, dim=2).transpose(1, 2)  # (B, H, S, D)
    out = torch.empty_like(q)
    scale = D ** -0.5
    for s0 in range(0, S, chunk):
        s1 = min(S, s0 + chunk)
        qc = q[:, s0:s1].transpose(1, 2)  # (B, H, c, D)
        sc = (qc @ kh[..., :s1]) * scale  # (B, H, c, s1)
        keep = torch.arange(s1, device=q.device)[None, :] <= torch.arange(s0, s1, device=q.device)[:, None]
        sc = sc.masked_fill(~keep, float("-inf"))
        out[:, s0:s1] = (torch.softmax(sc, dim=-1) @ vh[:, :, :s1]).transpose(1, 2)
    return out


def layer_params(params: Dict, i: int) -> Dict[str, torch.Tensor]:
    """Layer i's leaves, upcast to f32 one layer at a time."""
    out = {}
    for group in ("attn", "mlp"):
        for name, t in params["blocks"][group].items():
            out[name] = t[i].to(F32)
    for name in ("attn_norm", "mlp_norm"):
        out[name] = params["blocks"][name][i].to(F32)
    return out


def forward(params: Dict, model: Dict, tokens: torch.Tensor, *, logits_at: Optional[Sequence[int]] = None,
            precision: str = "f32", on_kv=None) -> Optional[torch.Tensor]:
    """Run ``tokens`` (B, S) from position 0.  ``on_kv(layer, k, v)`` gets each
    layer's keys (after QK-norm and RoPE) and values, (B, S, KVH, D) f32.
    Returns the logits (B, len(logits_at), V) at those positions, or None."""
    if precision not in ("f32", "fp8"):
        raise ValueError(f"precision {precision!r}: f32 or fp8")
    H, KVH, D = model["n_heads"], model["n_kv_heads"], model["d_head"]
    eps, theta = model["rms_norm_eps"], model["rope_theta"]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)
    with exact_f32(), torch.inference_mode():
        x = params["embed"][tokens].to(F32)
        for i in range(model["n_layers"]):
            p = layer_params(params, i)
            h = rms_norm(x, p["attn_norm"], eps)
            q = linear(h, p["wq"], precision)
            k = linear(h, p["wk"], precision)
            v = linear(h, p["wv"], precision)
            if model["qkv_bias"]:
                q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
            q, k, v = q.view(B, S, H, D), k.view(B, S, KVH, D), v.view(B, S, KVH, D)
            if model["qk_norm"]:
                q, k = rms_norm(q, p["q_norm"], eps), rms_norm(k, p["k_norm"], eps)
            q, k = rope(q, positions, theta), rope(k, positions, theta)
            if on_kv is not None:
                on_kv(i, k, v)
            a = causal_gqa(q, k, v)
            x = x + linear(a.reshape(B, S, H * D), p["wo"], precision)
            h = rms_norm(x, p["mlp_norm"], eps)
            g = linear(h, p["w_gate"], precision)
            u = linear(h, p["w_up"], precision)
            x = x + linear(torch.nn.functional.silu(g) * u, p["w_down"], precision)
            del p, h, q, k, v, a, g, u
        if logits_at is None:
            return None
        xs = rms_norm(x[:, list(logits_at)], params["final_norm"].to(F32), eps)
        return linear(xs, params["lm_head"], precision)
