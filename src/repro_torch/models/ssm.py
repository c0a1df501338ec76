"""Recurrent mixers: RWKV-6 'Finch' time/channel mix (data-dependent decay,
arXiv:2404.05892) and Mamba-2 SSD (arXiv:2405.21060).

Each has a sequence form, which runs the port's scan kernels (``wkv_model``
for RWKV6 at chunk 16, ``ssd_chunked`` for Mamba-2 at chunk 256), and a
single-step form for decode, which steps the recurrence in plain torch as
the reference does.  ``plain_kernels=True`` runs the kernels' plain
versions instead (on any device).  Dtypes follow the reference: bf16
activations and states for the shifts and the convolution tail, f32 for the
scans, their states, the decay, the norms and the D-skip.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..kernels.mamba2 import ssd_chunked, ssd_chunked_plain
from ..kernels.rwkv6 import wkv_chunked_plain, wkv_model
from .common import Spec

F32 = torch.float32
LORA_R = 32  # rank of the data-dependent interpolation MLPs (RWKV6 ddlerp)
WKV_CHUNK = 16   # the model's WKV chunk; it sets the log-decay clamp (-80/16)
SSD_CHUNK = 256  # the model's SSD chunk


# ---------------------------------------------------------------- RWKV-6
def build_rwkv6_template(cfg) -> Dict:
    D = cfg.d_model
    H, N = cfg.n_heads, cfg.d_head
    return {
        "time": {
            # token-shift interpolation: static mus + low-rank data-dependent
            "mu": Spec((5, D), init="small"),  # r,k,v,g,w
            "lora_a": Spec((5, D, LORA_R), init="small"),
            "lora_b": Spec((5, LORA_R, D), init="zeros"),
            "w0": Spec((D,), init="small"),  # decay bias
            "wr": Spec((D, D)),
            "wk": Spec((D, D)),
            "wv": Spec((D, D)),
            "wg": Spec((D, D)),
            "wo": Spec((D, D)),
            "u": Spec((H, N), init="small"),  # bonus for current token
            "ln_w": Spec((H, N), init="ones"),  # per-head group norm
            "ln_b": Spec((H, N), init="zeros"),
        },
        "chan": {
            "mu_k": Spec((D,), init="small"),
            "mu_r": Spec((D,), init="small"),
            "wk": Spec((D, cfg.d_ff)),
            "wv": Spec((cfg.d_ff, D)),
            "wr": Spec((D, D)),
        },
    }


def _ddlerp(p, x, x_prev):
    """RWKV6 data-dependent lerp: 5 mixed views of (x, shifted x)."""
    diff = x_prev - x  # (B,S,D)
    mixed = x[:, :, None, :] + diff[:, :, None, :] * p["mu"][None, None, :, :]
    lora = torch.einsum("bsfd,fdr->bsfr", torch.tanh(mixed), p["lora_a"])
    dyn = torch.einsum("bsfr,frd->bsfd", lora, p["lora_b"])
    out = x[:, :, None, :] + diff[:, :, None, :] * (p["mu"][None, None] + dyn)
    return out.unbind(dim=2)


def wkv_chunked(r, k, v, w, u, state, chunk: int = WKV_CHUNK, plain_kernels: bool = False):
    """Chunked RWKV6 WKV.  r/k/v (B,S,H,N) (bf16 on the model path), w
    (B,S,H,N) f32; u (H,N) f32; state (B,H,N,N) f32.  Returns (y (B,S,H,N)
    f32, state').  The WKV kernel reads the (B,S,H,N) views in place and pads
    the last chunk the way the reference does (r = k = v = 0, w = 1).
    ``plain_kernels`` may also be a function of the same arguments, which
    then runs in the scan's place (scripts/bf16_gate_sensitivity.py passes
    a float64 scan through ``greedy_decode``)."""
    if callable(plain_kernels):
        return plain_kernels(r, k, v, w, u, state, chunk)
    if plain_kernels:
        return wkv_chunked_plain(r, k, v, w, u, state, chunk)
    return wkv_model(r, k, v, w, u, state, chunk=chunk)


def _shifted(x, shift):
    """(B,S,D) -> the previous token's row at each step, ``shift`` first."""
    return torch.cat([shift[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def rwkv6_time_mix(p, cfg, x, state: Tuple, plain_kernels: bool = False):
    """x (B,S,D); state = (shift (B,D), wkv (B,H,N,N)).  Returns out + new
    state.  S == 1 steps sequentially in plain torch; longer sequences run
    the chunked scan."""
    B, S, D = x.shape
    H, N = cfg.n_heads, cfg.d_head
    shift, wkv = state
    xr, xk, xv, xg, xw = _ddlerp(p, x, _shifted(x, shift))
    r = torch.matmul(xr, p["wr"]).reshape(B, S, H, N)
    k = torch.matmul(xk, p["wk"]).reshape(B, S, H, N)
    v = torch.matmul(xv, p["wv"]).reshape(B, S, H, N)
    g = F.silu(torch.matmul(xg, p["wg"]))
    # data-dependent decay w in (0,1): exp(-exp(w0 + dyn))
    w = torch.exp(-torch.exp((p["w0"][None, None] + xw).to(F32))).reshape(B, S, H, N)
    u = p["u"].to(F32)

    if S > 1:
        y, wkv_new = wkv_chunked(r, k, v, w, u, wkv.to(F32), plain_kernels=plain_kernels)
    else:
        s = wkv.to(F32)
        ys = []
        for t in range(S):
            rt, kt, vt, wt = (z[:, t].to(F32) for z in (r, k, v, w))  # (B,H,N)
            kv = kt[..., :, None] * vt[..., None, :]
            ys.append(torch.einsum("bhi,bhij->bhj", rt, s + u[None, :, :, None] * kv))
            s = wt[..., :, None] * s + kv
        y, wkv_new = torch.stack(ys, dim=1), s
    # per-head group norm (population variance, as jnp.var)
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = (y - mean) * torch.rsqrt(var + 64e-5) * p["ln_w"][None, None] + p["ln_b"][None, None]
    out = (y.reshape(B, S, D) * g.to(F32)).to(x.dtype)
    out = torch.matmul(out, p["wo"])
    return out, (x[:, -1, :], wkv_new)


def rwkv6_channel_mix(p, cfg, x, shift):
    x_prev = _shifted(x, shift)
    xk = x + (x_prev - x) * p["mu_k"][None, None]
    xr = x + (x_prev - x) * p["mu_r"][None, None]
    k = torch.square(torch.relu(torch.matmul(xk, p["wk"])))
    kv = torch.matmul(k, p["wv"])
    r = torch.sigmoid(torch.matmul(xr, p["wr"]))
    return r * kv, x[:, -1, :]


def rwkv6_state_specs(cfg, batch: int):
    H, N, D = cfg.n_heads, cfg.d_head, cfg.d_model
    L = cfg.n_layers
    return {
        "time_shift": ((L, batch, D), torch.bfloat16),
        "wkv": ((L, batch, H, N, N), torch.float32),
        "chan_shift": ((L, batch, D), torch.bfloat16),
    }


def _zeros(specs, device):
    return {name: torch.zeros(shape, dtype=dtype, device=device) for name, (shape, dtype) in specs.items()}


def rwkv6_init_state(cfg, batch: int, device="cuda"):
    return _zeros(rwkv6_state_specs(cfg, batch), device)


# ---------------------------------------------------------------- Mamba-2
def build_mamba2_template(cfg) -> Dict:
    D = cfg.d_model
    d_in = cfg.expand * D
    H = cfg.ssm_heads
    N = cfg.ssm_state
    # in_proj emits z, x, B, C, dt
    return {
        "w_in": Spec((D, 2 * d_in + 2 * N + H)),
        "conv_w": Spec((cfg.d_conv, d_in + 2 * N), init="small"),
        "conv_b": Spec((d_in + 2 * N,), init="zeros"),
        "a_log": Spec((H,), init="small"),
        "dt_bias": Spec((H,), init="small"),
        "d_skip": Spec((H,), init="ones"),
        "norm_w": Spec((d_in,), init="ones"),
        "w_out": Spec((d_in, D)),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv1d.  x (B,S,C), w (K,C).  state (B,K-1,C) carries
    the tail of the previous segment; returns (y, new_state).  The K
    products are summed in x's dtype in the reference's order."""
    B, S, C = x.shape
    K = w.shape[0]
    if state is None:
        state = torch.zeros((B, K - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)  # (B, S+K-1, C)
    y = xp[:, 0:S, :] * w[0][None, None, :]
    for i in range(1, K):
        y = y + xp[:, i:i + S, :] * w[i][None, None, :]
    y = y + b[None, None, :]
    return F.silu(y), xp[:, -(K - 1):, :]


def mamba2_ssd_chunked(xin, Bm, Cm, a, dt, ssm0, chunk: int = SSD_CHUNK, plain_kernels: bool = False):
    """Chunked SSD.  xin (B,S,H,P); Bm/Cm (B,S,N); a/dt (B,S,H) f32; ssm0
    (B,H,P,N) f32.  Returns (y (B,S,H,P) f32, s').  The SSD kernel reads the
    model's views in place and tiles a 256-step chunk in 64-step blocks."""
    if plain_kernels:
        return ssd_chunked_plain(xin, Bm, Cm, a, dt, ssm0, chunk)
    return ssd_chunked(xin, Bm, Cm, a, dt, ssm0, chunk=chunk)


def _softplus(x):
    """log(1 + e^x) without torch's linear branch above 20 (jax.nn.softplus)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba2_mix(p, cfg, x, state: Tuple, plain_kernels: bool = False):
    """SSD sequence form.  state = (conv_state (B,K-1,C), ssm (B,H,P,N)).
    S == 1 steps sequentially in plain torch; longer sequences run the
    chunked scan."""
    B, S, D = x.shape
    d_in = cfg.expand * D
    H, N = cfg.ssm_heads, cfg.ssm_state
    P = d_in // H
    conv_state, ssm = state

    zxbcdt = torch.matmul(x, p["w_in"])
    z, xc, dt = zxbcdt[..., :d_in], zxbcdt[..., d_in:2 * d_in + 2 * N], zxbcdt[..., 2 * d_in + 2 * N:]
    xc, conv_new = _causal_conv(xc, p["conv_w"], p["conv_b"], conv_state)
    xin = xc[..., :d_in].reshape(B, S, H, P)
    Bm = xc[..., d_in:d_in + N]
    Cm = xc[..., d_in + N:]
    dt = _softplus(dt.to(F32) + p["dt_bias"][None, None].to(F32))  # (B,S,H)
    a = torch.exp(-dt * torch.exp(p["a_log"].to(F32))[None, None])  # decay (B,S,H)

    if S > 1:
        y, ssm_new = mamba2_ssd_chunked(xin, Bm, Cm, a, dt, ssm.to(F32), plain_kernels=plain_kernels)
    else:
        s = ssm.to(F32)
        ys = []
        for t in range(S):
            xt, bt, ct = xin[:, t].to(F32), Bm[:, t].to(F32), Cm[:, t].to(F32)
            at, dtt = a[:, t], dt[:, t]
            upd = dtt[..., None, None] * (xt[..., :, None] * bt[:, None, None, :])
            s = at[..., None, None] * s + upd  # (B,H,P,N)
            ys.append(torch.einsum("bhpn,bn->bhp", s, ct))
        y, ssm_new = torch.stack(ys, dim=1), s
    y = y + p["d_skip"].to(F32)[None, None, :, None] * xin.to(F32)
    y = y.reshape(B, S, d_in).to(x.dtype)
    # gated RMSNorm (mamba2 norm_before_gate=False)
    yf = y.to(F32) * F.silu(z.to(F32))
    yf = yf * torch.rsqrt(torch.mean(yf * yf, -1, keepdim=True) + 1e-6) * p["norm_w"].to(F32)
    out = torch.matmul(yf.to(x.dtype), p["w_out"])
    return out, (conv_new, ssm_new)


def mamba2_state_specs(cfg, batch: int):
    D = cfg.d_model
    d_in = cfg.expand * D
    H, N = cfg.ssm_heads, cfg.ssm_state
    P = d_in // H
    L = cfg.n_layers
    K = cfg.d_conv
    return {
        "conv": ((L, batch, K - 1, d_in + 2 * N), torch.bfloat16),
        "ssm": ((L, batch, H, P, N), torch.float32),
    }


def mamba2_init_state(cfg, batch: int, device="cuda"):
    return _zeros(mamba2_state_specs(cfg, batch), device)
