"""Plain PyTorch version of the flash-attention kernel: the same function,
computed with materialised scores.  Runs on any device."""

from __future__ import annotations

import torch

F32 = torch.float32


def attention_ref(q, k, v, causal: bool = True, q_offset: int = 0):
    """q (B, H, Sq, D); k (B, KVH, Skv, D); v (B, KVH, Skv, Dv) -> (B, H,
    Sq, Dv); GQA via head grouping, scores scaled by D^-0.5.  Query i sits
    at absolute position q_offset + i; key j at position j."""
    B, H, Sq, D = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    G = H // KVH
    qg = q.reshape(B, KVH, G, Sq, D).to(F32)
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.to(F32)) * (D**-0.5)
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        kpos = torch.arange(Skv, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.to(F32))
    return o.reshape(B, H, Sq, v.shape[-1]).to(q.dtype)


def flash_attention_plain(q, k, v, causal: bool = True, q_offset: int = 0):
    """Model layout: q (B, Sq, H, D); k (B, Skv, KVH, D); v (B, Skv, KVH,
    Dv) -> (B, Sq, H, Dv)."""
    out = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal, q_offset)
    return out.transpose(1, 2)
