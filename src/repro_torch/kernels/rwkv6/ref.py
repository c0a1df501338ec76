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


def wkv_chunked_plain(r, k, v, w, u, state, chunk: int = 16, dtype: torch.dtype = F32):
    """Model layout: r/k/v/w (B, S, H, N); u (H, N); state (B, H, N, N).
    S is padded to a multiple of ``chunk`` with r = k = v = 0 and w = 1
    (steps that leave the state as it is).  Evaluated in ``dtype`` (float32,
    as the kernel; scripts/bf16_gate_sensitivity.py asks for float64).
    Returns (y (B, S, H, N), new_state (B, H, N, N)) in ``dtype``."""
    B, S, H, N = r.shape
    pad = (-S) % chunk
    if pad:
        r, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    nc = (S + pad) // chunk

    def resh(t):
        return t.reshape(B, nc, chunk, H, N).transpose(0, 1).to(dtype)

    rc, kc, vc, wc = resh(r), resh(k), resh(v), resh(w)
    logw = torch.clamp(torch.log(torch.clamp(wc, min=1e-38)), min=-LOG_CLAMP / chunk)
    cum = cumsum_f32(logw, 2)  # (nc, B, C, H, N), inclusive
    cum_prev = cum - logw
    ti = torch.arange(chunk, device=r.device)
    upper = ti[:, None] <= ti[None, :]  # (t, j) with j >= t: not in the strict lower triangle
    s = state.to(dtype)
    uf = u.to(dtype)
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


ONE_GROUP = 8  # chunks a sequence may have and still run as one state group of the WKV kernel
GROUP = 4  # chunks per state group when there is more than one
SLAB = 16  # value columns per block of the WKV kernel
GROUP_SMEM = 200 << 10  # bytes of shared memory a walk block may take for its group


def _group_fit(chunk: int) -> int:
    """Chunks whose records, v and starting states a walk block holds in
    GROUP_SMEM (the kernel's Record and group_smem_bytes, v in f32)."""
    cp = -(-chunk // 4) * 4
    ldt = cp + 2
    record = 64 * ldt + cp * 64 + cp * ldt + cp + 64
    return GROUP_SMEM // (4 * (record + 2 * chunk * SLAB + 64 * SLAB))


def wkv_group_plan(S: int, chunk: int) -> tuple:
    """(chunks per state group, groups) the WKV kernel runs for S steps: one
    group, with no state pass, when the sequence has at most ``ONE_GROUP``
    chunks, else groups of ``GROUP``; never more than a walk block holds at
    this chunk length (3 at chunk 64)."""
    nc = -(-S // chunk)
    g = min(nc if nc <= ONE_GROUP else GROUP, max(1, _group_fit(chunk)))
    return g, -(-nc // g)


def _wkv_chunk(rb, kb, vb, wb, uf, s, chunk: int, outputs: bool):
    """One chunk of the kernel's arithmetic: (y or None, new state, exp(cum_last)).
    rb/kb/vb/wb (B, C, H, N) f32 (already padded), s (B, H, N, M) f32, M the
    value columns this block owns."""
    logw = torch.clamp(torch.log(torch.clamp(wb, min=1e-38)), min=-LOG_CLAMP / chunk)
    cum = cumsum_f32(logw, 1)
    cum_last = cum[:, -1]  # (B, H, N)
    ecl = torch.exp(cum_last)
    k_rem = kb * torch.exp(cum_last[:, None] - cum)
    y = None
    if outputs:
        r_dec = rb * torch.exp(cum - logw)
        k_inv = kb * torch.exp(-cum)
        A = torch.einsum("bthn,bjhn->bhtj", r_dec, k_inv)
        ti = torch.arange(chunk, device=rb.device)
        A = A.masked_fill(ti[:, None] <= ti[None, :], 0.0)
        y_inter = torch.einsum("bchn,bhnm->bchm", r_dec, s)
        y_intra = torch.einsum("bhtj,bjhm->bthm", A, vb)
        diag = torch.sum(rb * uf * kb, dim=-1)
        y = y_inter + y_intra + diag[..., None] * vb
    s = ecl[..., None] * s + torch.einsum("bchn,bchm->bhnm", k_rem, vb)
    return y, s, ecl


def wkv_tiles_plain(r, k, v, w, u, state, chunk: int = 16, group: int = None):
    """The WKV kernel's arithmetic in plain torch, model layout as
    ``wkv_chunked_plain`` (the same function).  Value columns go in slabs
    of ``SLAB``, each its own recurrence.  The chunks go in state groups
    (``wkv_group_plan``; ``group`` overrides the chunks per group): each
    group but the last forms its local state from zero and its total decay,
    a sequential pass turns them into every group's starting state, and
    each group then runs its chunks from that start, writing y (the last
    group also writes the final state).  Inside a chunk, as
    ``wkv_chunked_plain``, every product in f32 as the kernel forms it on
    the FMA units."""
    B, S, H, N = r.shape
    pad = (-S) % chunk
    if pad:
        r, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    nc = (S + pad) // chunk
    g, ng = wkv_group_plan(S, chunk) if group is None else (group, -(-nc // group))
    rc, kc, vc, wc = (t.to(F32) for t in (r, k, v, w))
    uf = u.to(F32)

    def steps(c):
        sl = slice(c * chunk, (c + 1) * chunk)
        return rc[:, sl], kc[:, sl], vc[:, sl], wc[:, sl]

    ys = torch.zeros((B, nc * chunk, H, N), dtype=F32, device=r.device)
    s_out = torch.empty((B, H, N, N), dtype=F32, device=r.device)
    for m0 in range(0, N, SLAB):
        cols = slice(m0, min(m0 + SLAB, N))
        starts = [state.to(F32)[..., cols]]
        for gi in range(ng - 1):  # (a) local states and decays, (b) the pass
            loc = torch.zeros_like(starts[0])
            dec = torch.ones((B, H, N), dtype=F32, device=r.device)
            for c in range(gi * g, (gi + 1) * g):
                rb, kb, vb, wb = steps(c)
                _, loc, ecl = _wkv_chunk(rb, kb, vb[..., cols], wb, uf, loc, chunk, False)
                dec = dec * ecl
            starts.append(dec[..., None] * starts[-1] + loc)
        for gi in range(ng):  # (c) outputs from each group's start
            s = starts[gi]
            for c in range(gi * g, min((gi + 1) * g, nc)):
                rb, kb, vb, wb = steps(c)
                y, s, _ = _wkv_chunk(rb, kb, vb[..., cols], wb, uf, s, chunk, True)
                ys[:, c * chunk:(c + 1) * chunk, :, cols] = y
        s_out[..., cols] = s
    return ys[:, :S], s_out
