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
    G = H // KVH if KVH else 0  # no KV heads: a rank's empty part of a split
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


def flash_tiles_plain(q, k, v, causal: bool = True, q_offset: int = 0, split_p: bool = True):
    """The bf16 kernel's arithmetic in plain torch, model layout as
    ``flash_attention_plain``: 64-key tiles, an f32 online softmax in log2
    units, and P·V with P split into P_hi = bf16(P) and P_lo = bf16(P - P_hi),
    each product against the tile's V in f32 (bf16 V is exact there).
    ``split_p=False`` rounds P to bf16 alone, as a tensor-core flash kernel
    usually does; the tests show why the kernel does not."""
    B, Sq, H, D = q.shape
    Skv, KVH, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // KVH
    qf = q.transpose(1, 2).reshape(B, KVH, G, Sq, D).to(F32)
    kf, vf = k.transpose(1, 2).to(F32), v.transpose(1, 2).to(F32)
    scale = D**-0.5 * 1.4426950408889634  # log2(e)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    m = torch.full((B, KVH, G, Sq), -1e30, dtype=F32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KVH, G, Sq, Dv), dtype=F32, device=q.device)
    for k0 in range(0, Skv, 64):  # the kernel's key tile
        kt, vt = kf[:, :, k0:k0 + 64], vf[:, :, k0:k0 + 64]
        s = torch.einsum("bkgsd,bktd->bkgst", qf, kt) * scale
        if causal:
            kpos = k0 + torch.arange(kt.shape[2], device=q.device)
            s = s.masked_fill(kpos[None, :] > qpos[:, None], -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        hi = p.to(torch.bfloat16).to(F32)
        pv = torch.einsum("bkgst,bktd->bkgsd", hi, vt)
        if split_p:
            pv = pv + torch.einsum("bkgst,bktd->bkgsd", (p - hi).to(torch.bfloat16).to(F32), vt)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, Sq, Dv).transpose(1, 2).to(q.dtype)
