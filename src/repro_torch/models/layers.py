"""Transformer layers of the dense decoders and of the hybrid's shared
block: RMSNorm, RoPE, GQA attention and the SwiGLU MLP.

Parameters arrive as dict trees built from ``build_*_template``.  Dtypes
follow the reference: bf16 storage, f32 for norms, RoPE, softmax and
accumulation.  Attention goes through the port's two kernels: the flash
kernel for prefill and the training forward, the paged decode kernel for
single-token decode; ``plain_kernels=True`` calls their plain PyTorch
versions instead (on any device), which is how a run on the card is held
against the plain path.  The reference's direct/chunked split at
``ATTN_CHUNK`` has no counterpart: both kernels are online-softmax loops.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.decode_attention import paged_decode, paged_decode_ref
from ..kernels.flash_attention import flash_attention, flash_attention_plain
from .common import Spec

F32 = torch.float32
PAGE = 16  # tokens per page when the dense cache is viewed as KV pages


# ------------------------------------------------------------------- norms
def rms_norm(x, w, eps: float = 1e-6):
    xf = x.to(F32)
    nrm = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (nrm * w.to(F32)).to(x.dtype)


def head_rms_norm(x, w, eps: float = 1e-6):
    """QK-norm: normalize over the head dim (..., H, D)."""
    return rms_norm(x, w, eps)


# -------------------------------------------------------------------- rope
def rope_tables(positions, dim: int, theta: float):
    """positions (...,) -> cos/sin tables (..., dim/2)."""
    # a Python scalar base: a device tensor made from ``theta`` would cost a
    # host-to-device copy, and a synchronise, in every layer
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=F32, device=positions.device) / dim))
    ang = positions.to(F32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (B, S, H, D); cos/sin (B, S, D/2) or (S, D/2)."""
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    if cos.dim() == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ----------------------------------------------------------- GQA attention
def build_gqa_template(cfg) -> Dict:
    D, H, KVH, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    t = {
        "wq": Spec((D, H * Dh)),
        "wk": Spec((D, KVH * Dh)),
        "wv": Spec((D, KVH * Dh)),
        "wo": Spec((H * Dh, D)),
    }
    if cfg.qkv_bias:
        t["bq"] = Spec((H * Dh,), init="zeros")
        t["bk"] = Spec((KVH * Dh,), init="zeros")
        t["bv"] = Spec((KVH * Dh,), init="zeros")
    if cfg.qk_norm:
        t["q_norm"] = Spec((Dh,), init="ones")
        t["k_norm"] = Spec((Dh,), init="ones")
    return t


def decode_index(B: int, S_max: int, kv_len: int, device):
    """Block tables and kv_len of a decode step over the dense cache viewed
    as PAGE-token pages: sequence b owns pages [b*NB, (b+1)*NB).  The same
    for every layer, so a forward builds them once."""
    if S_max % PAGE:
        raise ValueError(f"decode needs a cache length that is a multiple of {PAGE} "
                         f"(models.transformer.init_cache rounds it up), got {S_max}")
    NB = S_max // PAGE
    tables = torch.arange(B * NB, dtype=torch.int32, device=device).view(B, NB)
    lens = torch.full((B,), kv_len, dtype=torch.int32, device=device)
    return tables, lens


def _decode_over_cache(q, ck, cv, index, plain: bool):
    """One query token per sequence against the dense cache viewed, without
    a copy, as KV pages: (B, S_max, KVH, Dh) -> (B*S_max/PAGE, PAGE, KVH, Dh)."""
    B, S_max, KVH, Dh = ck.shape
    tables, lens = index
    kp = ck.view(B * (S_max // PAGE), PAGE, KVH, Dh)
    vp = cv.view(B * (S_max // PAGE), PAGE, KVH, Dh)
    fn = paged_decode_ref if plain else paged_decode
    return fn(q[:, 0], kp, vp, tables, lens)[:, None]


def gqa_attention(p, cfg, x, positions, cache: Optional[Tuple] = None, *,
                  q_offset: int = 0, plain_kernels: bool = False,
                  index: Optional[Tuple] = None):
    """x (B,S,D), positions (B,S) = q_offset + arange(S) in every row.

    ``cache=None``: self-attention over x only (training) -> (out, None).
    ``cache=(ck, cv, pos)``: ck/cv are (B, S_max, KVH, Dh); this call's K/V
    are written at offset ``pos`` and attention runs over the first
    ``pos+S`` slots -> (out, (ck, cv)).  Prefill (S > 1) runs the flash
    kernel over the cache slice, decode (S == 1) the paged decode kernel
    with ``index`` = ``decode_index(B, S_max, pos + 1)`` (built here when
    the caller passes none)."""
    B, S, D = x.shape
    H, KVH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = torch.matmul(x, p["wq"])
    k = torch.matmul(x, p["wk"])
    v = torch.matmul(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(B, S, H, Dh)
    k = k.reshape(B, S, KVH, Dh)
    v = v.reshape(B, S, KVH, Dh)
    if cfg.qk_norm:
        q = head_rms_norm(q, p["q_norm"])
        k = head_rms_norm(k, p["k_norm"])
    cos, sin = rope_tables(positions, Dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    flash = flash_attention_plain if plain_kernels else flash_attention

    if cache is None:
        out = flash(q, k, v, causal=cfg.causal, q_offset=q_offset)
        new_cache = None
    else:
        ck, cv, pos = cache
        # written in place: the caller's cache tensors are updated (the
        # reference returns updated copies; the port saves the copy)
        ck[:, pos:pos + S] = k
        cv[:, pos:pos + S] = v
        if S == 1:  # kv_len = pos + 1 masks exactly what causality would
            if index is None:
                index = decode_index(B, ck.shape[1], pos + 1, x.device)
            out = _decode_over_cache(q, ck, cv, index, plain_kernels)
        else:
            out = flash(q, ck[:, :pos + S], cv[:, :pos + S], causal=cfg.causal, q_offset=pos)
        new_cache = (ck, cv)
    out = torch.matmul(out.reshape(B, S, H * Dh), p["wo"])
    return out, new_cache


# --------------------------------------------------------------------- MLP
def build_mlp_template(cfg, d_ff: Optional[int] = None) -> Dict:
    D = cfg.d_model
    Fd = d_ff or cfg.d_ff
    return {"w_gate": Spec((D, Fd)), "w_up": Spec((D, Fd)), "w_down": Spec((Fd, D))}


def swiglu_mlp(p, x):
    h = F.silu(torch.matmul(x, p["w_gate"])) * torch.matmul(x, p["w_up"])
    return torch.matmul(h, p["w_down"])
