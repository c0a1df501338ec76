"""Plain PyTorch versions of the RWKV6 WKV kernel.  Run on any device.

    y_t = r_t · (S_{t-1} + (u ∘ k_t) v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

``wkv_ref`` steps that recurrence token by token (the oracle).
``wkv_chunked_plain`` is the chunked closed form the kernel computes, the
same as the reference's ``models/ssm.py::wkv_chunked`` and the Pallas
``_kernel``: per-token log-decay is clamped at ``-LOG_CLAMP / chunk``, so
the chunk length is part of the function.  Where a channel decays faster
than that (log w < -5 at chunk 16), chunk 16 and chunk 32 give different
results, in both packages alike.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32
LOG_CLAMP = 80.0


def cumsum_f32(x, dim: int):
    """Inclusive cumulative sum along ``dim``, one f32 addition per step in
    sequence order: the order the kernel takes it in, so that both round the
    same way (``torch.cumsum`` takes another order on the card, and another
    precision on the CPU)."""
    out = torch.empty_like(x)
    acc = x.select(dim, 0)
    out.select(dim, 0).copy_(acc)
    for i in range(1, x.shape[dim]):
        acc = acc + x.select(dim, i)
        out.select(dim, i).copy_(acc)
    return out


def wkv_ref(r, k, v, w, u, state):
    """r/k/v/w (B, H, S, N); u (H, N); state (B, H, N, N).  Returns
    (y (B, H, S, N) f32, new_state (B, H, N, N) f32)."""
    s = state.to(F32)
    uf = u.to(F32)[None, :, :, None]
    ys = []
    for t in range(r.shape[2]):
        rt, kt, vt, wt = (x[:, :, t].to(F32) for x in (r, k, v, w))
        kv = kt[..., :, None] * vt[..., None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", rt, s + uf * kv))
        s = wt[..., :, None] * s + kv
    return torch.stack(ys, dim=2), s


def wkv_chunked_plain(r, k, v, w, u, state, chunk: int = 16):
    """Model layout: r/k/v/w (B, S, H, N); u (H, N); state (B, H, N, N).
    S is padded to a multiple of ``chunk`` with r = k = v = 0 and w = 1
    (steps that leave the state as it is).  Returns (y (B, S, H, N) f32,
    new_state (B, H, N, N) f32)."""
    B, S, H, N = r.shape
    pad = (-S) % chunk
    if pad:
        r, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    nc = (S + pad) // chunk

    def resh(t):
        return t.reshape(B, nc, chunk, H, N).transpose(0, 1).to(F32)

    rc, kc, vc, wc = resh(r), resh(k), resh(v), resh(w)
    logw = torch.clamp(torch.log(torch.clamp(wc, min=1e-38)), min=-LOG_CLAMP / chunk)
    cum = cumsum_f32(logw, 2)  # (nc, B, C, H, N), inclusive
    cum_prev = cum - logw
    ti = torch.arange(chunk, device=r.device)
    upper = ti[:, None] <= ti[None, :]  # (t, j) with j >= t: not in the strict lower triangle
    s = state.to(F32)
    uf = u.to(F32)
    ys = []
    for c in range(nc):
        rb, kb, vb, cumb = rc[c], kc[c], vc[c], cum[c]
        r_dec = rb * torch.exp(cum_prev[c])  # exponent <= 0
        k_inv = kb * torch.exp(-cumb)  # bounded by the clamp
        y_inter = torch.einsum("bchn,bhnm->bchm", r_dec, s)
        A = torch.einsum("bthn,bjhn->bhtj", r_dec, k_inv).masked_fill(upper, 0.0)
        y_intra = torch.einsum("bhtj,bjhm->bthm", A, vb)
        diag = torch.sum(rb * uf * kb, dim=-1)  # (B, C, H)
        ys.append(y_inter + y_intra + diag[..., None] * vb)
        cum_last = cumb[:, -1]  # (B, H, N)
        k_rem = kb * torch.exp(cum_last[:, None] - cumb)
        s = torch.exp(cum_last)[..., None] * s + torch.einsum("bchn,bchm->bhnm", k_rem, vb)
    y = torch.stack(ys, dim=1).reshape(B, nc * chunk, H, N)
    return y[:, :S], s
