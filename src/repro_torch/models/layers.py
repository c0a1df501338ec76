"""Transformer layers: RMSNorm, RoPE, GQA and MLA attention, the SwiGLU
MLP and the sort-based top-k MoE.

Parameters arrive as dict trees built from ``build_*_template``.  Dtypes
follow the reference: bf16 storage, f32 for norms, RoPE, softmax and
accumulation.  Attention goes through the port's two kernels: the flash
kernel for prefill and the training forward (its full entry point, any
key count, for non-causal attention: whisper's encoder and
cross-attention), the paged decode kernel for single-token decode;
``plain_kernels=True`` calls their plain PyTorch versions instead (on any
device), which is how a run on the card is held against the plain path.  The reference's direct/chunked split at
``ATTN_CHUNK`` has no counterpart: both kernels are online-softmax loops.
MLA's prefill runs the flash kernel at q/k head dim 96 and v head dim 64;
its decode is the reference's absorbed path in latent space, plain torch
as in the reference, and launches nothing.  The MoE's expert products
are batched matmuls, which the reference also leaves outside any kernel.

Under ``common.tensor_parallel`` with a ``model`` axis over 1 (the
training forward, and prefill and decode with a cache), the layers split
at the reference's constrain sites: GQA attention over KV heads or query
groups (``common.grouped_head_split``), MLA attention over heads, the
SwiGLU hidden dim, and the MoE's experts.  Each rank takes views of its
columns and rows of parameters it holds whole; the replicated input
enters through ``copy_to_model`` and the partial output leaves through
``reduce_from_model``.  Parameters the rules keep whole but that act on
the split (the QK-norm scales) enter through ``copy_to_model`` too, so
their gradients come out whole on every rank.  A GQA cache, held whole
on every rank, is read and written through a view of the rank's KV heads
(every KV head where the split is over query groups); MLA's latent cache
is whole on every rank.  A split wider than its dim leaves some ranks an
empty part (``common.split_range``), which every layer runs through.

While the residual stream is split over sequence (``common.sequence_split``:
the training forward of the dense and moe families under ``cfg.seq_shard``)
a layer's input holds the rank's ``S / model`` rows: the input enters the
split through an all-gather of the rows (``common.enter_split``) and the
partial output leaves it through a reduce-scatter back to them
(``common.leave_split``).  What acts row by row runs on the rank's rows:
MLA's down-projections and their norms, whose narrower outputs (the
latent query, ``c`` and ``k_rope``: 1056 wide at minicpm3-4b's D 2560)
are gathered in place of the D-wide input, so no rank repeats their
products; and the MoE's router, whose gate weights and expert ids are
gathered for the dispatch and whose probabilities stay on the rows.
Those parameters enter through ``common.on_rows``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.decode_attention import paged_decode, paged_decode_ref
from ..kernels.flash_attention import flash_attention, flash_attention_full, flash_attention_plain
from .common import (Spec, copy_to_model, current_tp, enter_split, gather_rows, grouped_head_split, leave_split,
                     on_rows, seq_rows, split_range)

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


def decode_index(B: int, S_max: int, kv_len, device):
    """Block tables and kv_len of a decode step over the dense cache viewed
    as PAGE-token pages: sequence b owns pages [b*NB, (b+1)*NB).  The same
    for every layer, so a forward builds them once.  ``kv_len`` is an int
    or a 0-d integer tensor on ``device``; a tensor is broadcast on the
    device, so no host value enters the step (a CUDA graph replays it)."""
    if S_max % PAGE:
        raise ValueError(f"decode needs a cache length that is a multiple of {PAGE} "
                         f"(models.transformer.init_cache rounds it up), got {S_max}")
    NB = S_max // PAGE
    tables = torch.arange(B * NB, dtype=torch.int32, device=device).view(B, NB)
    if isinstance(kv_len, torch.Tensor):
        lens = kv_len.to(torch.int32).reshape(1).expand(B).contiguous()
    else:
        lens = torch.full((B,), kv_len, dtype=torch.int32, device=device)
    return tables, lens


def write_cache(buf, new, pos) -> None:
    """buf (B, S_max, ...) <- new (B, S, ...) at slots [pos, pos + S), in
    place.  ``pos`` is an int, or a 0-d integer tensor on buf's device
    (written with ``index_copy_``, so the slot is read on the device: the
    reference's ``dynamic_update_slice`` at a traced pos)."""
    if isinstance(pos, torch.Tensor):
        buf.index_copy_(1, pos + torch.arange(new.shape[1], device=buf.device), new)
    else:
        buf[:, pos:pos + new.shape[1]] = new


def attend(q, k, v, causal: bool, q_offset: int, plain: bool):
    """Flash attention in model layout: causal through ``flash_attention``,
    non-causal through ``flash_attention_full`` (every key visible, any key
    count); ``plain`` runs the plain version instead.  A rank's empty part
    of a split (no heads) takes the same route: on the card the wrappers
    return an empty output without a launch."""
    if plain:
        return flash_attention_plain(q, k, v, causal, q_offset)
    if causal:
        return flash_attention(q, k, v, causal=True, q_offset=q_offset)
    return flash_attention_full(q, k, v)


def decode_over_cache(q, ck, cv, index, plain: bool):
    """One query token per sequence against the dense cache viewed, without
    a copy, as KV pages: (B, S_max, KVH, Dh) -> (B*S_max/PAGE, PAGE, KVH, Dh).
    ``ck``/``cv`` may be a rank's KV-head view of a whole cache
    (``kv_head_view``): the pages are then strided too, their slots the
    whole cache's KVH·Dh elements apart and their pages PAGE times that,
    and ``paged_decode`` reads them in place at those page and slot
    strides (``decode_attention.page_strides``)."""
    B, S_max, KVH, Dh = ck.shape
    tables, lens = index
    kp = ck.view(B * (S_max // PAGE), PAGE, KVH, Dh)
    vp = cv.view(B * (S_max // PAGE), PAGE, KVH, Dh)
    fn = paged_decode_ref if plain else paged_decode
    return fn(q[:, 0], kp, vp, tables, lens)[:, None]


def take_heads(w, dim: int, kvh: int, g: int, dh: int, kv: Tuple[int, int], gs: Tuple[int, int]):
    """The heads [kv) x [gs) of ``w``'s dim ``dim``, laid out (kvh, g, dh),
    as that dim again (a view where they are contiguous, else a copy)."""
    dim %= w.dim()
    w = w.unflatten(dim, (kvh, g, dh))
    w = w.narrow(dim, kv[0], kv[1] - kv[0]).narrow(dim + 1, gs[0], gs[1] - gs[0])
    return w.flatten(dim, dim + 2)


def gqa_heads(cfg, tp):
    """(KV heads [lo, hi), query groups [lo, hi)) of this model rank's part
    of a GQA layer: split over KV heads or over the query groups of every
    KV head (``common.grouped_head_split``, in uneven slices, some empty,
    where ``model`` divides neither)."""
    KVH = cfg.n_kv_heads
    G = cfg.n_heads // KVH
    m, r = tp.model_size, tp.model_rank
    if grouped_head_split(KVH, G, m) == "kvh":
        return split_range(KVH, m, r), (0, G)
    return (0, KVH), split_range(G, m, r)


def kv_head_view(buf, kv: Tuple[int, int]):
    """The KV heads [kv) of a cache leaf (B, S, KVH, Dh), as a view."""
    return buf[:, :, kv[0]:kv[1]]


def gqa_shard(p, cfg, tp):
    """This model rank's part of a GQA (or cross-attention) layer: the q, k
    and v columns and ``wo`` rows of its heads (``gqa_heads``),
    ``qkv_bias`` following its heads and the QK-norm scales whole through
    ``copy_to_model``."""
    H, KVH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    G = H // KVH
    kv, gs = gqa_heads(cfg, tp)
    out = {}
    for name, w in p.items():
        if name in ("q_norm", "k_norm"):
            out[name] = copy_to_model(w, tp)
        elif name in ("wq", "bq", "wo"):
            out[name] = take_heads(w, 0 if name == "wo" else -1, KVH, G, Dh, kv, gs)
        else:  # wk, wv, bk, bv
            out[name] = take_heads(w, -1, KVH, 1, Dh, kv, (0, 1))
    return out


def gqa_attention(p, cfg, x, positions, cache: Optional[Tuple] = None, *,
                  q_offset: int = 0, plain_kernels: bool = False,
                  index: Optional[Tuple] = None):
    """x (B,S,D), positions (B,S) = q_offset + arange(S) in every row.

    ``cache=None``: self-attention over x only (training) -> (out, None).
    ``cache=(ck, cv, pos)``: ck/cv are (B, S_max, KVH, Dh); this call's K/V
    are written at offset ``pos`` and attention runs over the first
    ``pos+S`` slots -> (out, (ck, cv)).  Prefill (S > 1, ``pos`` an int)
    runs the flash kernel over the cache slice, decode (S == 1, ``pos`` an
    int or a 0-d tensor) the paged decode kernel with ``index`` =
    ``decode_index(B, S_max, pos + 1)`` (built here when the caller passes
    none).  Under a tensor-parallel context: this rank's heads
    (``gqa_shard``), summed over ``model`` after ``wo``, and of the cache
    (held whole) the view of its KV heads (``gqa_heads``, ``kv_head_view``:
    contiguous over heads and head dims, its slots the whole cache's
    KVH·Dh apart), which the flash kernel reads at its batch and sequence
    strides and the paged decode kernel at its page and slot strides, with
    no copy; x is the rank's rows of the sequence, and so is the output,
    while the stream is split over it."""
    Dh = cfg.d_head
    tp = current_tp()
    if tp is not None:
        p, x = gqa_shard(p, cfg, tp), enter_split(x, tp)
        if cache is not None:
            kv = gqa_heads(cfg, tp)[0]
            cache = (kv_head_view(cache[0], kv), kv_head_view(cache[1], kv), cache[2])
    B, S, _ = x.shape
    H, KVH = p["wo"].shape[0] // Dh, p["wk"].shape[-1] // Dh
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

    if cache is None:
        out = attend(q, k, v, cfg.causal, q_offset, plain_kernels)
        new_cache = None
    else:
        ck, cv, pos = cache
        # written in place: the caller's cache tensors are updated (the
        # reference returns updated copies; the port saves the copy)
        write_cache(ck, k, pos)
        write_cache(cv, v, pos)
        if S == 1:  # kv_len = pos + 1 masks exactly what causality would
            if index is None:
                index = decode_index(B, ck.shape[1], pos + 1, x.device)
            out = decode_over_cache(q, ck, cv, index, plain_kernels)
        else:
            out = attend(q, ck[:, :pos + S], cv[:, :pos + S], cfg.causal, pos, plain_kernels)
        new_cache = (ck, cv)
    out = torch.matmul(out.reshape(B, S, H * Dh), p["wo"])
    if tp is not None:
        out = leave_split(out, tp)
    return out, new_cache


# ----------------------------------------------------------- MLA attention
def build_mla_template(cfg) -> Dict:
    D, H = cfg.d_model, cfg.n_heads
    r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq_a": Spec((D, r_q)),
        "q_a_norm": Spec((r_q,), init="ones"),
        "wq_b": Spec((r_q, H * (dn + dr))),
        "wkv_a": Spec((D, r_kv + dr)),
        "kv_a_norm": Spec((r_kv,), init="ones"),
        "wk_b": Spec((r_kv, H * dn)),
        "wv_b": Spec((r_kv, H * dv)),
        "wo": Spec((H * dv, D)),
    }


def mla_project_latent(p, cfg, x, positions):
    """x -> (c_kv (B,S,r), k_rope (B,S,dr)): the compressed per-token state
    that the cache holds."""
    r_kv, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    kv_a = torch.matmul(x, p["wkv_a"])
    c_kv = rms_norm(kv_a[..., :r_kv], p["kv_a_norm"])
    cos, sin = rope_tables(positions, dr, cfg.rope_theta)
    k_rope = apply_rope(kv_a[..., None, r_kv:], cos, sin)[:, :, 0, :]
    return c_kv, k_rope


def mla_queries(p, cfg, x, positions):
    """x -> (q_nope (B,S,H,dn), q_rope (B,S,H,dr)); H is the heads ``wq_b``
    holds (this rank's under a tensor-parallel context, where the latent
    query enters the split through ``common.enter_split``: gathered from
    x's rows while the stream is split over sequence, and S, with
    ``positions``, then every row's)."""
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    q_a = rms_norm(torch.matmul(x, p["wq_a"]), p["q_a_norm"])
    tp = current_tp()
    if tp is not None:
        q_a = enter_split(q_a, tp)
    B, S, _ = q_a.shape
    H = p["wq_b"].shape[-1] // (dn + dr)
    q = torch.matmul(q_a, p["wq_b"]).reshape(B, S, H, dn + dr)
    cos, sin = rope_tables(positions, dr, cfg.rope_theta)
    return q[..., :dn], apply_rope(q[..., dn:], cos, sin)


def _mla_absorbed(p, cfg, q_nope, q_rope, c_kv, k_rope, kv_len):
    """One query token against the latent slots (B, T, ·), in f32 in latent
    space: q_nope is taken through wk_b, the output back through wv_b, so
    per-head K/V are never formed (reference ``layers.py:276-301``).  Slots
    at or past ``kv_len`` (an int or a 0-d tensor: the query's position
    + 1) are masked, as the reference's kv_len and causal mask do."""
    B, S, H, dn = q_nope.shape
    r, dr, dv = cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.v_head_dim
    wk = p["wk_b"].reshape(r, H, dn).to(F32)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope.to(F32), wk)
    scores = torch.einsum("bshr,btr->bhst", q_lat, c_kv.to(F32))
    scores = scores + torch.einsum("bshd,btd->bhst", q_rope.to(F32), k_rope.to(F32))
    scores = scores / ((dn + dr) ** 0.5)
    hidden = torch.arange(c_kv.shape[1], device=c_kv.device) >= kv_len
    pr = torch.softmax(scores.masked_fill(hidden, -1e30), dim=-1)
    o_lat = torch.einsum("bhst,btr->bshr", pr, c_kv.to(F32))
    wv = p["wv_b"].reshape(r, H, dv).to(F32)
    return torch.einsum("bshr,rhd->bshd", o_lat, wv)


def mla_shard(p, cfg, tp):
    """This model rank's heads of an MLA layer: ``wq_b``, ``wk_b`` and
    ``wv_b`` columns and ``wo`` rows; the latent projections and their
    norms stay whole (they run before the split, on the rank's rows
    while the stream is split over sequence: ``common.on_rows``)."""
    H, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    hs = split_range(H, tp.model_size, tp.model_rank)
    per = {"wq_b": dn + dr, "wk_b": dn, "wv_b": dv, "wo": dv}
    return {name: take_heads(w, 0 if name == "wo" else -1, H, 1, per[name], hs, (0, 1)) if name in per
            else on_rows(w) for name, w in p.items()}


def mla_attention(p, cfg, x, positions, cache: Optional[Tuple] = None, *,
                  q_offset: int = 0, plain_kernels: bool = False):
    """MLA attention.  x (B,S,D), positions (B,S) = q_offset + arange(S).

    ``cache=None``: training, over x only -> (out, None).  ``cache=(c, kr,
    pos)`` with c (B,S_max,r) and kr (B,S_max,dr): this call's latent is
    written at offset ``pos``, in place, and attention runs over the first
    ``pos+S`` slots -> (out, (c, kr)).  S > 1 (and training) expands the
    latent to per-head K/V and runs the flash kernel at q/k head dim
    dn+dr, v head dim dv; S == 1 with a cache takes the absorbed path over
    every S_max slot with kv_len = pos + 1 masking the rest, as the
    reference does, so ``pos`` may there be a 0-d tensor.  Under a
    tensor-parallel context: this rank's heads (``mla_shard``), the latent
    entering the split through ``common.enter_split``, summed over
    ``model`` after ``wo``; every rank writes the whole latent into its
    whole cache.  While the stream is split over sequence, x and the
    output are the rank's rows, and the latent is projected from x's rows
    (at their positions) and gathered."""
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    tp = current_tp()
    if tp is not None:
        p = mla_shard(p, cfg, tp)
    H = p["wo"].shape[0] // dv
    q_nope, q_rope = mla_queries(p, cfg, x, positions)
    B, S = q_nope.shape[:2]
    rows = seq_rows(positions, tp) if tp is not None and tp.seq_split else positions  # x's positions
    c_new, kr_new = mla_project_latent(p, cfg, x, rows)
    if tp is not None:
        c_new, kr_new = enter_split(c_new, tp), enter_split(kr_new, tp)

    if cache is None:
        c_kv, k_rope, new_cache, pos = c_new, kr_new, None, q_offset
    else:
        c_all, kr_all, pos = cache
        write_cache(c_all, c_new, pos)
        write_cache(kr_all, kr_new, pos)
        new_cache = (c_all, kr_all)

    if cache is not None and S == 1:
        out = _mla_absorbed(p, cfg, q_nope, q_rope, c_all, kr_all, pos + 1).to(x.dtype)
    else:
        if cache is not None:
            c_kv, k_rope = c_all[:, :pos + S], kr_all[:, :pos + S]
        T = c_kv.shape[1]
        k_nope = torch.matmul(c_kv, p["wk_b"]).reshape(B, T, H, dn)
        v = torch.matmul(c_kv, p["wv_b"]).reshape(B, T, H, dv)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, T, H, dr)], dim=-1)
        out = attend(q, k, v, cfg.causal, pos, plain_kernels)
    out = torch.matmul(out.reshape(B, S, H * dv), p["wo"])
    if tp is not None:
        out = leave_split(out, tp)
    return out, new_cache


# --------------------------------------------------------------------- MLP
def build_mlp_template(cfg, d_ff: Optional[int] = None) -> Dict:
    D = cfg.d_model
    Fd = d_ff or cfg.d_ff
    return {"w_gate": Spec((D, Fd)), "w_up": Spec((D, Fd)), "w_down": Spec((Fd, D))}


def swiglu_mlp(p, x):
    """SwiGLU; under a tensor-parallel context this rank's slice of the
    hidden dim (``w_gate``/``w_up`` columns, ``w_down`` rows), summed over
    ``model`` (x and the output the rank's rows of the sequence while the
    stream is split over it)."""
    tp = current_tp()
    if tp is not None:
        lo, hi = split_range(p["w_down"].shape[0], tp.model_size, tp.model_rank)
        p = {"w_gate": p["w_gate"][:, lo:hi], "w_up": p["w_up"][:, lo:hi], "w_down": p["w_down"][lo:hi]}
        x = enter_split(x, tp)
    h = F.silu(torch.matmul(x, p["w_gate"])) * torch.matmul(x, p["w_up"])
    out = torch.matmul(h, p["w_down"])
    return out if tp is None else leave_split(out, tp)


# --------------------------------------------------------------------- MoE
def build_moe_template(cfg) -> Dict:
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    return {
        "router": Spec((D, E), dtype=F32, init="small"),
        "w_gate": Spec((E, D, Fd)),
        "w_up": Spec((E, D, Fd)),
        "w_down": Spec((E, Fd, D)),
    }


def moe_capacity(cfg, S: int, dropless: bool) -> int:
    """Expert slots per dispatch group (one batch row of S tokens), as the
    reference sizes them: every slot a group could need when dropless and
    S·k <= 4096, else the capacity factor (at least 2 when dropless)."""
    E, k = cfg.n_experts, cfg.experts_per_token
    if dropless and S * k <= 4096:
        return S * k
    if dropless:
        return max(k, int(round(S * k / E * max(2.0, cfg.capacity_factor))))
    return max(1, int(round(S * k / E * cfg.capacity_factor)))


def moe_route(p, cfg, x):
    """Router in f32: (probs (B,S,E), gate weights (B,S,k) renormalised,
    expert ids (B,S,k)).  A stable descending sort keeps the lower expert
    id first among equal probabilities, as ``lax.top_k`` does."""
    logits = torch.matmul(x.to(F32), p["router"].to(F32))
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    gate_w, gate_e = vals[..., :k], ids[..., :k]
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_w, gate_e


def _take_rows(x, idx):
    """x (B, N, D), idx (B, M) -> (B, M, D) with out[b, m] = x[b, idx[b, m]]:
    the reference's ``take_along_axis`` over rows, as one row gather (no
    (B, M, D) index tensor)."""
    B, N, D = x.shape
    flat = idx + torch.arange(B, device=idx.device)[:, None] * N
    return x.reshape(B * N, D).index_select(0, flat.reshape(-1)).reshape(B, idx.shape[1], D)


def moe_layer(p, cfg, x, dropless: bool = False):
    """Top-k token-choice MoE with group-local sort-based dispatch (one
    group per batch row), the reference's ``moe_layer`` step for step:
    the routed (token, choice) pairs are sorted by expert, each expert
    takes the first C of its pairs into a (B, E, C, D) buffer (the rest
    drop), the experts run as batched matmuls, and each token sums its k
    outputs weighted by its gates.  Returns (out (B,S,D), probs (B·S, E)
    f32).

    Under a tensor-parallel context the route runs whole on every rank
    (so ``probs``, and the balance term built on it, are the same on
    each), each rank fills and runs the (B, E/model, C, D) buffer of its
    experts, combines only the slots its experts own, and the partial
    outputs are summed over ``model``.  While the stream is split over
    sequence, x and the output are the rank's rows: the route runs on
    them (``probs`` are theirs), and x, the gate weights and the expert
    ids are gathered, so the dispatch, and its capacity, see every row."""
    E, k = cfg.n_experts, cfg.experts_per_token
    dev = x.device
    tp = current_tp()
    probs, gate_w, gate_e = moe_route({"router": on_rows(p["router"])}, cfg, x)
    e0, El = 0, E  # this rank's experts [e0, e0 + El)
    if tp is not None:
        e0, e1 = split_range(E, tp.model_size, tp.model_rank)
        El = e1 - e0
        p = {n: p[n][e0:e1] for n in ("w_gate", "w_up", "w_down")}
        x, gate_w = enter_split(x, tp), enter_split(gate_w, tp)
        if tp.seq_split:
            gate_e = gather_rows(gate_e, tp)
    B, S, D = x.shape
    C = moe_capacity(cfg, S, dropless)

    flat_e = gate_e.reshape(B, S * k)
    sorted_e, order = torch.sort(flat_e, dim=-1, stable=True)
    first = torch.searchsorted(sorted_e, torch.arange(E, device=dev).expand(B, E).contiguous())  # (B,E)
    pos_in_e = torch.arange(S * k, device=dev)[None, :] - torch.gather(first, 1, sorted_e)
    valid = pos_in_e < C
    tok_of = order // k

    # dispatch: buf[b, e, c] = sorted slot first[b, e] + c
    xs_sorted = _take_rows(x, tok_of)  # (B, S*k, D)
    slot = first[:, e0:e0 + El, None] + torch.arange(C, device=dev)[None, None, :]  # (B,El,C)
    ends = torch.cat([first[:, 1:], torch.full((B, 1), S * k, device=dev, dtype=first.dtype)], dim=1)
    slot_ok = (slot < ends[:, e0:e0 + El, None]).reshape(B, El * C)
    slot_flat = torch.clamp(slot, 0, S * k - 1).reshape(B, El * C)
    # the buffer is masked in place and let go once h is formed (the
    # reference makes a masked copy and holds both to the end): at kimi-k2's
    # 128-token prefill it is (1, 384, 1024, 7168) bf16, 5.64 GB, and the
    # copy and the longer life cost 11.3 GB of device memory at the peak
    buf = _take_rows(xs_sorted, slot_flat)  # (B, El*C, D)
    buf = buf.masked_fill_(~slot_ok[..., None], 0).reshape(B, El, C, D)

    h = F.silu(torch.matmul(buf, p["w_gate"])) * torch.matmul(buf, p["w_up"])  # (B,E,C,F)
    del buf
    y = torch.matmul(h, p["w_down"])  # (B,E,C,D)

    # combine: sorted slot j reads y[sorted_e[j], pos_in_e[j]], weighted by
    # its gate (cast to the activation dtype, as the reference does), then
    # the inverse permutation restores token order and the k slots are
    # summed; under tensor parallelism a rank keeps the slots of its experts
    if tp is not None:
        valid = valid & (sorted_e >= e0) & (sorted_e < e0 + El)
        sorted_e = sorted_e - e0
    if El:
        flat_pos = torch.clamp(sorted_e * C + torch.where(valid, pos_in_e, 0), 0, El * C - 1)
        picked_sorted = _take_rows(y.reshape(B, El * C, D), flat_pos)
    else:  # no experts on this rank: zero rows, kept on the autograd graph
        picked_sorted = y.reshape(B, 0, D).sum(1, keepdim=True).expand(B, S * k, D)
    w_sorted = torch.gather(gate_w.reshape(B, S * k), 1, order)
    picked_sorted = picked_sorted * (w_sorted * valid)[..., None].to(y.dtype)
    inv_order = torch.argsort(order, dim=-1)
    picked = _take_rows(picked_sorted, inv_order)
    out = picked.reshape(B, S, k, D).sum(dim=2)
    if tp is not None:
        out = leave_split(out, tp)
    return out, probs.reshape(-1, E)


def moe_aux_loss(probs, gate_e, n_experts: int):
    """Switch-style load-balancing loss: E · Σ_e mean prob · mean load."""
    me = probs.mean(dim=0)
    ce = F.one_hot(gate_e, n_experts).to(F32).sum(dim=1).mean(dim=0)
    return n_experts * torch.sum(me * ce)
