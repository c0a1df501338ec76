"""Plain PyTorch version of paged decode attention.

Gathers the block table back into a contiguous KV view and runs masked
single-token attention.  A row with ``kv_len = 0`` gives zeros, as the
kernel does (the reference's ``ref.py`` gives the mean of the gathered V
there, because every score is -1e30 and its softmax is uniform)."""

from __future__ import annotations

import torch

F32 = torch.float32


def paged_decode_ref(q, k_pages, v_pages, block_tables, kv_len):
    """q (B, H, D); k/v_pages (P, page, KVH, D); block_tables (B, NB) int32
    page ids; kv_len (B,) valid tokens.  Returns (B, H, D)."""
    B, H, D = q.shape
    P, page, KVH, _ = k_pages.shape
    NB = block_tables.shape[1]
    G = H // KVH if KVH else 0  # no KV heads: a rank's empty part of a split
    idx = block_tables.long()
    k = k_pages[idx].reshape(B, NB * page, KVH, D)
    v = v_pages[idx].reshape(B, NB * page, KVH, D)
    T = NB * page
    qg = q.reshape(B, KVH, G, D).to(F32)
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k.to(F32)) / (D**0.5)
    lens = kv_len.to(q.device).long()
    mask = torch.arange(T, device=q.device)[None, :] < lens[:, None]  # (B, T)
    scores = scores.masked_fill(~mask[:, None, None, :], -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v.to(F32))
    out = out * (lens > 0).to(F32)[:, None, None, None]  # kv_len = 0 -> zeros
    return out.reshape(B, H, D).to(q.dtype)


def paged_decode_split_plain(q, k_pages, v_pages, block_tables, kv_len, sm_count: int):
    """The kernel's arithmetic in plain torch: the slot range cut as
    ``ops.split_plan`` cuts it, a partial softmax (m, l, acc) per split in
    f32, then the join acc = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s
    over the splits that hold a valid slot; none gives zeros.  Same
    arguments and result as ``paged_decode_ref``, and the card's SM count,
    which the split depends on."""
    from .ops import split_plan  # ops imports this module

    B, H, D = q.shape
    P, page, KVH, _ = k_pages.shape
    NB = block_tables.shape[1]
    G = H // KVH
    T = NB * page
    n, L = split_plan(B, KVH, T, sm_count)
    idx = block_tables.long()
    k = k_pages[idx].reshape(B, T, KVH, D).to(F32)
    v = v_pages[idx].reshape(B, T, KVH, D).to(F32)
    pad = n * L - T
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)).reshape(B, n, L, KVH, D)
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)).reshape(B, n, L, KVH, D)
    lens = kv_len.to(q.device).long().clamp(0, T)
    valid = (torch.arange(n * L, device=q.device)[None, :] < lens[:, None]).reshape(B, 1, 1, n, L)
    qg = q.reshape(B, KVH, G, D).to(F32)
    s = torch.einsum("bkgd,bnlkd->bkgnl", qg, k) * (D**-0.5)
    live = valid.any(-1)                                          # (B, 1, 1, n)
    m = torch.where(live, s.masked_fill(~valid, -torch.inf).amax(-1), torch.zeros((), device=q.device))
    p = torch.exp(s - m[..., None]).masked_fill(~valid, 0.0)
    l = p.sum(-1)                                                 # (B, KVH, G, n)
    acc = torch.einsum("bkgnl,bnlkd->bkgnd", p, v)
    M = m.masked_fill(~live, -torch.inf).amax(-1, keepdim=True)
    w = torch.where(live, torch.exp(m - M), torch.zeros((), device=q.device))
    out = (w[..., None] * acc).sum(-2) / (w * l).sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(B, H, D).to(q.dtype)
