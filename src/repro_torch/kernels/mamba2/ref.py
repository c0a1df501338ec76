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
