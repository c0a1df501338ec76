"""Plain PyTorch versions of the Mamba-2 SSD kernel.  Run on any device.

    S_t = a_t S_{t-1} + dt_t (x_t ⊗ B_t)
    y_t = C_t · S_t

``ssd_ref`` steps that recurrence token by token (the oracle).
``ssd_chunked_plain`` is the chunked form the kernel computes, the same as
the reference's ``models/ssm.py::mamba2_ssd_chunked`` and the Pallas
``_kernel``: masked intra-chunk products built from log-differences of the
per-head scalar decay.  SSD has no clamp, so every chunk length computes
the same recurrence up to f32 rounding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..rwkv6.ref import cumsum_f32

F32 = torch.float32


def ssd_ref(x, Bm, Cm, a, dt, state):
    """x (B,S,H,P); Bm/Cm (B,S,N); a/dt (B,S,H); state (B,H,P,N).  Returns
    (y (B,S,H,P) f32, new_state (B,H,P,N) f32)."""
    s = state.to(F32)
    ys = []
    for t in range(x.shape[1]):
        xt, bt, ct = x[:, t].to(F32), Bm[:, t].to(F32), Cm[:, t].to(F32)
        at, dtt = a[:, t].to(F32), dt[:, t].to(F32)
        upd = dtt[..., None, None] * (xt[..., :, None] * bt[:, None, None, :])
        s = at[..., None, None] * s + upd
        ys.append(torch.einsum("bhpn,bn->bhp", s, ct))
    return torch.stack(ys, dim=1), s


def ssd_chunked_plain(xin, Bm, Cm, a, dt, ssm0, chunk: int = 256):
    """xin (B,S,H,P); Bm/Cm (B,S,N); a/dt (B,S,H) f32; ssm0 (B,H,P,N) f32.
    S is padded to a multiple of ``chunk`` with x = B = C = 0, a = 1 and
    dt = 0 (steps that leave the state as it is).  Returns (y (B,S,H,P)
    f32, new_state (B,H,P,N) f32)."""
    B_, S, H, P = xin.shape
    N = Bm.shape[-1]
    pad = (-S) % chunk
    if pad:
        xin = F.pad(xin, (0, 0, 0, 0, 0, pad))
        Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = (S + pad) // chunk
    xc = xin.reshape(B_, nc, chunk, H, P).transpose(0, 1).to(F32)
    bc = Bm.reshape(B_, nc, chunk, N).transpose(0, 1).to(F32)
    cc = Cm.reshape(B_, nc, chunk, N).transpose(0, 1).to(F32)
    ac = a.reshape(B_, nc, chunk, H).transpose(0, 1).to(F32)
    dc = dt.reshape(B_, nc, chunk, H).transpose(0, 1).to(F32)
    # log-differences are formed before exp, so the kept (j <= t) entries
    # have exponent <= 0; masked entries are -inf before the exp
    cum = cumsum_f32(torch.log(torch.clamp(ac, min=1e-38)), 2)  # (nc,B,C,H)
    ti = torch.arange(chunk, device=xin.device)
    incl = (ti[:, None] >= ti[None, :])[None, :, :, None]  # j <= t
    s = ssm0.to(F32)
    ys = []
    for c in range(nc):
        xb, bb, cb, cumb, db = xc[c], bc[c], cc[c], cum[c], dc[c]
        G = torch.einsum("btn,bjn->btj", cb, bb)
        delta = cumb[:, :, None, :] - cumb[:, None, :, :]  # (B,t,j,H)
        L = torch.exp(delta.masked_fill(~incl, float("-inf")))
        W = G[..., None] * L * db[:, None]
        y_intra = torch.einsum("btjh,bjhp->bthp", W, xb)
        y_inter = torch.exp(cumb)[..., None] * torch.einsum("btn,bhpn->bthp", cb, s)
        cum_last = cumb[:, -1]  # (B,H)
        decay_rem = torch.exp(cum_last[:, None] - cumb) * db  # (B,C,H)
        s = torch.exp(cum_last)[..., None, None] * s + torch.einsum(
            "bch,bchp,bcn->bhpn", decay_rem, xb, bb)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(B_, nc * chunk, H, P)
    return y[:, :S], s


def split_bf16(x):
    """An f32 tensor as three bf16 pieces, hi = bf16(x), mid = bf16(x - hi)
    and lo = bf16(x - hi - mid), each returned in f32: hi keeps x to about
    2^-9 of itself, hi + mid to 2^-17, all three to 2^-25.  For a tensor
    that holds bf16 values, mid and lo are zero."""
    hi = x.to(torch.bfloat16).to(F32)
    mid = (x - hi).to(torch.bfloat16).to(F32)
    return hi, mid, (x - hi - mid).to(torch.bfloat16).to(F32)


PRODUCTS = ("f32", "bf16x3", "bf16")


def split_einsum(eq: str, a, b, a_exact: bool, b_exact: bool, products: str = "bf16x3"):
    """``einsum(eq, a, b)`` with its products formed as ``products`` says,
    every product summed in f32.  "f32": as they are (the FMA units).
    "bf16x3": as the SSD kernel runs them on bf16 tensor cores: an operand
    that holds bf16 values (``*_exact``) goes in as it is, any other is
    split into hi, mid and lo (``split_bf16``), and the products of pieces
    whose orders (hi 0, mid 1, lo 2) sum to at most 2 are taken (hi·hi,
    hi·mid, mid·hi, hi·lo, lo·hi, mid·mid; only those with an exact
    operand's hi when one is exact), which keeps each product to ~2^-24 of
    itself; a split into hi and mid alone (2^-17) uses up to 0.94 of the
    scan's tolerance at the test shapes.  "bf16": each f32 operand rounded
    to bf16 once, as a tensor-core kernel usually would; the tests show
    that this breaks the tolerances."""
    if products == "f32":
        return torch.einsum(eq, a.to(F32), b.to(F32))
    if products not in PRODUCTS:
        raise ValueError(f"products must be one of {PRODUCTS}, got {products!r}")
    pa, pb = split_bf16(a), split_bf16(b)
    out = torch.einsum(eq, pa[0], pb[0])
    if products == "bf16":
        return out
    for i, j in ((0, 1), (1, 0), (0, 2), (2, 0), (1, 1)):
        if (i and a_exact) or (j and b_exact):
            continue
        out = out + torch.einsum(eq, pa[i], pb[j])
    return out


TILE = 64  # steps per row and column tile of a chunk in the SSD kernel


def ssd_tiles_plain(xin, Bm, Cm, a, dt, ssm0, chunk: int = 256, products: str = "bf16x3"):
    """The SSD kernel's arithmetic in plain torch, layout as
    ``ssd_chunked_plain`` (the same function).  (a) Every chunk's local
    state from zero, Σ_j (exp(cum_last - cum_j) dt_j x_j) ⊗ B_j, all
    chunks independent; (b) the sequential pass S ← exp(cum_last) S +
    local, which gives each chunk's starting state; (c) each chunk's
    outputs in 64-row tiles, y = exp(cum_t) C·S_startᵀ + Σ over the column
    tiles on or below the diagonal of W·x, W = (C·Bᵀ) ∘ exp(cum_t - cum_j)
    ∘ dt_j for j <= t.  Every product runs on bf16 tensor cores
    (``split_einsum``, ``products="bf16x3"``): x, B and C go in exactly when
    they arrive in bf16; every other operand (and x, B, C in f32) is split
    into three bf16 pieces."""
    B_, S, H, P = xin.shape
    N = Bm.shape[-1]
    exact = xin.dtype == torch.bfloat16
    nc = -(-S // chunk)
    Sp = nc * chunk
    xf = F.pad(xin.to(F32), (0, 0, 0, 0, 0, Sp - S))
    bf, cf = (F.pad(t.to(F32), (0, 0, 0, Sp - S)) for t in (Bm, Cm))
    af = F.pad(a.to(F32), (0, 0, 0, Sp - S), value=1.0)
    df = F.pad(dt.to(F32), (0, 0, 0, Sp - S))
    cum = cumsum_f32(torch.log(torch.clamp(af.reshape(B_, nc, chunk, H), min=1e-38)), 2)  # per chunk
    cum = cum.reshape(B_, Sp, H)
    # (a) local states
    local = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        cl = cum[:, sl][:, -1]  # (B, H)
        dr = torch.exp(cl[:, None] - cum[:, sl]) * df[:, sl]  # (B, C, H)
        local.append(split_einsum("bchp,bcn->bhpn", dr[..., None] * xf[:, sl], bf[:, sl], False, exact, products))
    # (b) the state pass
    starts, s = [], ssm0.to(F32)
    for c in range(nc):
        starts.append(s)
        s = torch.exp(cum[:, (c + 1) * chunk - 1])[..., None, None] * s + local[c]
    # (c) outputs, one 64-row tile at a time
    y = torch.empty((B_, Sp, H, P), dtype=F32, device=xin.device)
    for c in range(nc):
        for r0 in range(0, chunk, TILE):
            rows = slice(c * chunk + r0, c * chunk + min(r0 + TILE, chunk))
            ct, cumt = cf[:, rows], cum[:, rows]
            acc = torch.exp(cumt)[..., None] * split_einsum("btn,bhpn->bthp", ct, starts[c], exact, False, products)
            t = torch.arange(rows.start, rows.stop, device=xin.device)
            for j0 in range(0, r0 + 1, TILE):
                cols = slice(c * chunk + j0, c * chunk + min(j0 + TILE, chunk))
                j = torch.arange(cols.start, cols.stop, device=xin.device)
                G = split_einsum("btn,bjn->btj", ct, bf[:, cols], exact, exact, products)
                delta = cumt[:, :, None, :] - cum[:, None, cols, :]  # (B, t, j, H)
                L = torch.exp(delta.masked_fill((j[None, :] > t[:, None])[None, :, :, None], float("-inf")))
                W = G[..., None] * L * df[:, None, cols]
                acc = acc + split_einsum("btjh,bjhp->bthp", W, xf[:, cols], False, exact, products)
            y[:, rows] = acc
    return y[:, :S], s
