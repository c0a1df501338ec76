"""Decoder-LM assembly, dense family: one forward covering train (no
cache), prefill (cache fill at a reused-prefix offset) and decode (single
step).  Layers are stacked on a leading L axis, as in the reference, and
driven by a Python loop in place of ``lax.scan``.

Only the dense family is ported so far; the other families raise
``NotImplementedError`` naming their item in ROADMAP.md.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .common import Spec, tree_init
from .layers import (PAGE, build_gqa_template, build_mlp_template, decode_index, gqa_attention,
                     rms_norm, swiglu_mlp)

_NOT_PORTED = {
    "moe": "ROADMAP.md queue 1 item 3 (MoE + MLA)",
    "mla": "ROADMAP.md queue 1 item 3 (MoE + MLA)",
    "rwkv6": "ROADMAP.md queue 1 item 4 (RWKV6)",
    "hybrid": "ROADMAP.md queue 1 item 5 (Mamba-2 hybrid)",
    "encdec": "ROADMAP.md queue 1 item 6 (Whisper enc-dec)",
}


def require_dense(cfg) -> None:
    kind = "mla" if cfg.attention == "mla" else cfg.family
    if kind != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {kind} family is not ported to PyTorch yet; see {_NOT_PORTED.get(kind, 'ROADMAP.md queue 1')}")


# ------------------------------------------------------------- templates
def build_block_template(cfg) -> Dict:
    require_dense(cfg)
    return {
        "attn_norm": Spec((cfg.d_model,), init="ones"),
        "attn": build_gqa_template(cfg),
        "mlp_norm": Spec((cfg.d_model,), init="ones"),
        "mlp": build_mlp_template(cfg),
    }


def _stack(template, L: int):
    if isinstance(template, dict):
        return {k: _stack(v, L) for k, v in template.items()}
    return Spec((L,) + template.shape, template.dtype, template.init, template.scale)


def build_lm_template(cfg) -> Dict:
    D, V = cfg.d_model, cfg.vocab_size
    return {
        "embed": Spec((V, D), scale=1.0),
        "blocks": _stack(build_block_template(cfg), cfg.n_layers),
        "final_norm": Spec((D,), init="ones"),
        "lm_head": Spec((D, V)),
    }


def lm_init(cfg, seed: int = 0, device="cuda"):
    return tree_init(build_lm_template(cfg), seed, device)


# ----------------------------------------------------------------- caches
def cache_len(max_seq: int) -> int:
    """Cache slots for ``max_seq`` tokens, rounded up to a whole number of
    decode pages: decode views each layer's cache as PAGE-token pages.  The
    extra slots always sit at or past kv_len and are masked."""
    return -(-max_seq // PAGE) * PAGE


def cache_specs(cfg, batch: int, max_seq: int) -> Dict:
    """Shapes and dtype of the serve-time cache (the object the LSM store
    persists block-wise): bf16 k/v of shape (L, B, S, KVH, Dh)."""
    require_dense(cfg)
    shape = (cfg.n_layers, batch, cache_len(max_seq), cfg.n_kv_heads, cfg.d_head)
    return {"k": (shape, torch.bfloat16), "v": (shape, torch.bfloat16)}


def init_cache(cfg, batch: int, max_seq: int, device="cuda"):
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in cache_specs(cfg, batch, max_seq).items()}


# ---------------------------------------------------------------- forward
def embed_tokens(embed, tokens):
    """Row lookup with ids clamped to [0, V-1]: the reference's gather
    clamps out-of-range ids the same way (``e[[V + 5]]`` is the last row),
    while torch's indexing would raise on the CPU and assert on the card."""
    return embed[tokens.clamp(0, embed.shape[0] - 1)]


def lm_forward(params, cfg, tokens, pos: int = 0, cache: Optional[Dict] = None,
               plain_attention: bool = False):
    """tokens (B,S) int.  ``cache=None`` => training forward.  Otherwise the
    cache is consumed and updated in place at offset ``pos`` (an int).
    Returns (logits (B,S,V), cache, aux)."""
    require_dense(cfg)
    B, S = tokens.shape
    x = embed_tokens(params["embed"], tokens)
    positions = (pos + torch.arange(S, dtype=torch.int32, device=x.device))[None, :].expand(B, S)
    index = None
    if cache is not None and S == 1:
        index = decode_index(B, cache["k"].shape[2], pos + 1, x.device)
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        bp = {"attn": {k: t[i] for k, t in blocks["attn"].items()},
              "mlp": {k: t[i] for k, t in blocks["mlp"].items()}}
        layer_cache = None if cache is None else (cache["k"][i], cache["v"][i], pos)
        h = rms_norm(x, blocks["attn_norm"][i])
        h, _ = gqa_attention(bp["attn"], cfg, h, positions, layer_cache,
                             q_offset=pos, plain_attention=plain_attention, index=index)
        x = x + h
        h = rms_norm(x, blocks["mlp_norm"][i])
        x = x + swiglu_mlp(bp["mlp"], h)
    x = rms_norm(x, params["final_norm"])
    logits = torch.matmul(x, params["lm_head"])
    return logits, cache, {"aux_loss": 0.0}  # dense: no auxiliary loss
