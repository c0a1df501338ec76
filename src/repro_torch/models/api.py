"""Model API with the reference's call shapes, dense family:

  init_params(cfg, key, device)                  params on ``device``
  init_cache(cfg, batch, max_seq, device)        bf16 k/v cache
  prefill_fn(cfg)(params, inputs, cache, pos)    -> (logits, cache)
  decode_fn(cfg)(params, tokens, cache, pos)     -> (logits (B,1,V), cache)

``key`` is an int seed or a ``torch.Generator`` whose ``initial_seed()`` is
used.  ``device`` defaults to ``cuda``; the CPU runs only when asked for.
"""

from __future__ import annotations

from . import transformer
from ..configs.base import ModelConfig


def _seed(key) -> int:
    return int(key.initial_seed()) if hasattr(key, "initial_seed") else int(key)


def init_params(cfg: ModelConfig, key=0, device="cuda"):
    return transformer.lm_init(cfg, _seed(key), device)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda"):
    return transformer.init_cache(cfg, batch, max_seq, device)


def prefill_fn(cfg: ModelConfig, plain_attention: bool = False):
    """(params, inputs, cache, pos) -> (logits, cache).  ``inputs`` is the
    batch dict with ``tokens`` (B, S)."""
    transformer.require_dense(cfg)

    def prefill(params, inputs, cache, pos=0):
        logits, new_cache, _ = transformer.lm_forward(
            params, cfg, inputs["tokens"], pos=pos, cache=cache, plain_attention=plain_attention)
        return logits, new_cache

    return prefill


def decode_fn(cfg: ModelConfig, plain_attention: bool = False):
    """(params, tokens (B,1), cache, pos) -> (logits (B,1,V), cache)."""
    transformer.require_dense(cfg)

    def decode(params, tokens, cache, pos):
        logits, new_cache, _ = transformer.lm_forward(
            params, cfg, tokens, pos=pos, cache=cache, plain_attention=plain_attention)
        return logits, new_cache

    return decode
