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
    G = H // KVH
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
