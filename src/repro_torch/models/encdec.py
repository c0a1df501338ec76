"""Whisper-style encoder-decoder backbone.  The conv/mel frontend is a stub,
as in the reference: the caller supplies precomputed frame embeddings
(B, enc_frames, d_model); everything downstream (bidirectional encoder,
causal decoder with cross-attention, KV caches) is real.

Attention runs through the port's two kernels: the encoder's
self-attention and prefill cross-attention through the flash kernel's full
entry point (every key visible, 1500 frames, no block multiple), the
decoder's causal self-attention as in ``layers.gqa_attention``, and decode
cross-attention through the paged decode kernel over the cross cache,
kv_len = enc_frames.  Layers are stacked on a leading L axis, as in the
reference, and driven by a Python loop in place of ``lax.scan``.

Under ``common.tensor_parallel`` with a ``model`` axis over 1 (training,
prefill and decode) the encoder's and decoder's attention and MLP split as
in ``layers.py``, cross-attention over the same heads (``layers.gqa_shard``:
the queries of this rank's heads against the K/V of its KV heads, built
from the memory entering through ``copy_to_model``), the self and cross
caches, held whole, through views of this rank's KV heads, and the logits
and the loss over the vocabulary as in ``transformer.py``.  The reference's batch-only
constraints (``encdec.py:109,147,160``) are the layout the port has.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .common import Spec, copy_to_model, current_tp, reduce_from_model, tree_init
from .layers import (F32, decode_over_cache, attend, build_gqa_template, build_mlp_template, decode_index,
                     gqa_attention, gqa_heads, gqa_shard, kv_head_view, rms_norm, swiglu_mlp)
from .transformer import (cache_len, check_pos, checkpointed, embed_tokens, stacked, token_cross_entropy, unstack,
                          vocab_logits)


# ------------------------------------------------------------- templates
def build_cross_template(cfg) -> Dict:
    D, H, KVH, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    return {
        "wq": Spec((D, H * Dh)),
        "wk": Spec((D, KVH * Dh)),
        "wv": Spec((D, KVH * Dh)),
        "wo": Spec((H * Dh, D)),
    }


def build_encdec_template(cfg) -> Dict:
    D, V = cfg.d_model, cfg.vocab_size
    enc_block = {
        "attn_norm": Spec((D,), init="ones"),
        "attn": build_gqa_template(cfg),
        "mlp_norm": Spec((D,), init="ones"),
        "mlp": build_mlp_template(cfg),
    }
    dec_block = {
        "self_norm": Spec((D,), init="ones"),
        "self_attn": build_gqa_template(cfg),
        "cross_norm": Spec((D,), init="ones"),
        "cross": build_cross_template(cfg),
        "mlp_norm": Spec((D,), init="ones"),
        "mlp": build_mlp_template(cfg),
    }
    return {
        "enc_blocks": stacked(enc_block, cfg.n_enc_layers),
        "enc_norm": Spec((D,), init="ones"),
        "embed": Spec((V, D), scale=1.0),
        "dec_blocks": stacked(dec_block, cfg.n_layers),
        "final_norm": Spec((D,), init="ones"),
        "lm_head": Spec((D, V)),
    }


def encdec_init(cfg, seed: int = 0, device="cuda"):
    return tree_init(build_encdec_template(cfg), seed, device)


# ------------------------------------------------------- cross-attention
def cross_kv(p, mem, cfg):
    """Encoder memory (B,T,D) -> cross K/V, each (B,T,KVH,Dh); no RoPE.
    Under a tensor-parallel context, the KV heads of this rank's split
    (``layers.gqa_shard``)."""
    B, T, _ = mem.shape
    Dh = cfg.d_head
    tp = current_tp()
    if tp is not None:
        p, mem = gqa_shard(p, cfg, tp), copy_to_model(mem, tp)
    k = torch.matmul(mem, p["wk"]).reshape(B, T, -1, Dh)
    v = torch.matmul(mem, p["wv"]).reshape(B, T, -1, Dh)
    return k, v


def _cross_queries(p, cfg, x):
    B, S, _ = x.shape
    return torch.matmul(x, p["wq"]).reshape(B, S, -1, cfg.d_head)


def _cross_out(p, cfg, out):
    B, S = out.shape[:2]
    return torch.matmul(out.reshape(B, S, -1), p["wo"])


def cross_attention(p, cfg, x, mem_k, mem_v, plain_kernels: bool = False):
    """Decoder x (B,S,D) attends to every one of the T encoder positions
    in mem_k/mem_v (B,T,KVH,Dh); no RoPE, no qk-norm (as the reference).
    Under a tensor-parallel context: this rank's query heads against the
    KV heads ``cross_kv`` gave it, summed over ``model`` after ``wo``."""
    tp = current_tp()
    if tp is not None:
        p, x = gqa_shard(p, cfg, tp), copy_to_model(x, tp)
    out = _cross_out(p, cfg, attend(_cross_queries(p, cfg, x), mem_k, mem_v, False, 0, plain_kernels))
    return out if tp is None else reduce_from_model(out, tp)


def cross_decode(p, cfg, x, ck, cv, index, plain_kernels: bool = False):
    """One decoder token per sequence, x (B,1,D), against the cross cache
    ck/cv (B, cache_len(T), KVH, Dh) viewed as pages; ``index`` =
    ``decode_index(B, cache_len(T), T)``, so the pad slots past T are
    masked.  Under a tensor-parallel context: this rank's query heads
    against ``ck``/``cv``, the view of its KV heads, summed over
    ``model`` after ``wo``."""
    tp = current_tp()
    if tp is not None:
        p, x = gqa_shard(p, cfg, tp), copy_to_model(x, tp)
    out = _cross_out(p, cfg, decode_over_cache(_cross_queries(p, cfg, x), ck, cv, index, plain_kernels))
    return out if tp is None else reduce_from_model(out, tp)


# ---------------------------------------------------------------- encoder
def encode(params, cfg, frames, plain_kernels: bool = False):
    """frames (B, T_enc, D) from the stub frontend -> encoder memory
    (B, T_enc, D): bidirectional self-attention with RoPE at 0..T-1."""
    enc_cfg = dataclasses.replace(cfg, causal=False)
    B, T, _ = frames.shape
    positions = torch.arange(T, dtype=torch.int32, device=frames.device)[None, :].expand(B, T)

    def enc_block(x, bp):
        h, _ = gqa_attention(bp["attn"], enc_cfg, rms_norm(x, bp["attn_norm"]), positions,
                             plain_kernels=plain_kernels)
        x = x + h
        return x + swiglu_mlp(bp["mlp"], rms_norm(x, bp["mlp_norm"]))

    block = checkpointed(enc_block, cfg.remat)
    x = frames
    for bp in unstack(params["enc_blocks"], cfg.n_enc_layers):
        x = block(x, bp)
    return rms_norm(x, params["enc_norm"])


# ----------------------------------------------------------------- caches
def encdec_cache_specs(cfg, batch: int, max_seq: int) -> Dict:
    """bf16 self k/v (L, B, cache_len(max_seq), KVH, Dh) and cross k/v
    (L, B, cache_len(enc_frames), KVH, Dh): both rounded up to whole
    decode pages; the slots past enc_frames stay zero and masked."""
    L, B, KVH, Dh = cfg.n_layers, batch, cfg.n_kv_heads, cfg.d_head
    self_shape = (L, B, cache_len(max_seq), KVH, Dh)
    cross_shape = (L, B, cache_len(cfg.enc_frames), KVH, Dh)
    return {"self_k": (self_shape, torch.bfloat16), "self_v": (self_shape, torch.bfloat16),
            "cross_k": (cross_shape, torch.bfloat16), "cross_v": (cross_shape, torch.bfloat16)}


def encdec_init_cache(cfg, batch: int, max_seq: int, device="cuda"):
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in encdec_cache_specs(cfg, batch, max_seq).items()}


# ---------------------------------------------------------------- decoder
def decode_forward(params, cfg, tokens, memory=None, pos: int = 0, cache: Optional[Dict] = None,
                   plain_kernels: bool = False):
    """Decoder forward over tokens (B,S) -> (logits (B,S,V), cache).

    ``cache=None`` (training): the cross K/V are built from ``memory``.
    With a cache, updated in place at offset ``pos``: given ``memory``
    (prefill), the cross K/V are built from it and written into the cross
    cache, whose length must then be enc_frames; without it (decode), the
    cross cache is read, by the paged decode kernel when S == 1.  A decode
    step's ``pos`` may be a 0-d integer tensor on the model's device
    (``transformer.lm_forward``).  Under a tensor-parallel context the
    logits are this rank's vocabulary columns, and the cross cache is read
    and written through the view of this rank's KV heads
    (``layers.gqa_heads``; the self cache's view is taken in
    ``layers.gqa_attention``)."""
    B, S = tokens.shape
    check_pos(pos, S, cache)
    x = embed_tokens(params["embed"], tokens)
    dev = x.device
    positions = (pos + torch.arange(S, dtype=torch.int32, device=dev))[None, :].expand(B, S)
    T = cfg.enc_frames
    if cache is None and memory is None:
        raise ValueError("decode_forward without a cache needs the encoder memory")
    if cache is not None and memory is not None and memory.shape[1] != T:
        raise ValueError(f"the cross cache holds enc_frames = {T} frames, memory has {memory.shape[1]}")
    self_index = cross_index = None
    if cache is not None and S == 1:
        self_index = decode_index(B, cache["self_k"].shape[2], pos + 1, dev)
        if memory is None:
            cross_index = decode_index(B, cache["cross_k"].shape[2], T, dev)

    tp = current_tp()

    def cross_cache(name, i):
        return cache[name][i] if tp is None else kv_head_view(cache[name][i], gqa_heads(cfg, tp)[0])

    def dec_block(x, bp, i):
        self_cache = None if cache is None else (cache["self_k"][i], cache["self_v"][i], pos)
        h, _ = gqa_attention(bp["self_attn"], cfg, rms_norm(x, bp["self_norm"]), positions, self_cache,
                             q_offset=pos, plain_kernels=plain_kernels, index=self_index)
        x = x + h
        hx = rms_norm(x, bp["cross_norm"])
        if memory is not None:
            mk, mv = cross_kv(bp["cross"], memory, cfg)
            if cache is not None:  # prefill: (re)write the cross cache
                cross_cache("cross_k", i)[:, :T].copy_(mk)
                cross_cache("cross_v", i)[:, :T].copy_(mv)
            x = x + cross_attention(bp["cross"], cfg, hx, mk, mv, plain_kernels)
        elif cross_index is not None:
            x = x + cross_decode(bp["cross"], cfg, hx, cross_cache("cross_k", i), cross_cache("cross_v", i),
                                 cross_index, plain_kernels)
        else:
            x = x + cross_attention(bp["cross"], cfg, hx, cross_cache("cross_k", i)[:, :T],
                                    cross_cache("cross_v", i)[:, :T], plain_kernels)
        return x + swiglu_mlp(bp["mlp"], rms_norm(x, bp["mlp_norm"]))

    block = checkpointed(dec_block, cfg.remat and cache is None)
    for i, bp in enumerate(unstack(params["dec_blocks"], cfg.n_layers)):
        x = block(x, bp, i)

    x = rms_norm(x, params["final_norm"])
    return vocab_logits(x, params["lm_head"]), cache


def encdec_loss(params, cfg, batch, plain_kernels: bool = False):
    """Mean next-token cross-entropy over labels >= 0 of the decoder on
    the encoded ``batch["frames"]`` -> (loss, {"ce", "aux"}), aux zero."""
    memory = encode(params, cfg, batch["frames"], plain_kernels)
    logits, _ = decode_forward(params, cfg, batch["tokens"], memory=memory, plain_kernels=plain_kernels)
    loss = token_cross_entropy(logits, batch["labels"], cfg.vocab_size)
    return loss, {"ce": loss, "aux": torch.zeros((), dtype=F32, device=loss.device)}
