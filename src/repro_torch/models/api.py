"""Model API with the reference's call shapes, for the dense (GQA or MLA),
moe, rwkv6 and hybrid families:

  init_params(cfg, key, device)                  params on ``device``
  init_cache(cfg, batch, max_seq, device)        k/v cache and recurrent states
  prefill_fn(cfg)(params, inputs, cache, pos)    -> (logits, cache)
  decode_fn(cfg)(params, tokens, cache, pos)     -> (logits (B,1,V), cache)

``key`` is an int seed or a ``torch.Generator`` whose ``initial_seed()`` is
used.  ``device`` defaults to ``cuda``; the CPU runs only when asked for.
``plain_kernels=True`` runs every kernel's plain PyTorch version instead of
the kernel, which is how a run on the card is held against the plain path.
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


def prefill_fn(cfg: ModelConfig, plain_kernels: bool = False):
    """(params, inputs, cache, pos) -> (logits, cache).  ``inputs`` is the
    batch dict with ``tokens`` (B, S)."""
    transformer.require_ported(cfg)

    def prefill(params, inputs, cache, pos=0):
        logits, new_cache, _ = transformer.lm_forward(
            params, cfg, inputs["tokens"], pos=pos, cache=cache, plain_kernels=plain_kernels)
        return logits, new_cache

    return prefill


def decode_fn(cfg: ModelConfig, plain_kernels: bool = False):
    """(params, tokens (B,1), cache, pos) -> (logits (B,1,V), cache)."""
    transformer.require_ported(cfg)

    def decode(params, tokens, cache, pos):
        logits, new_cache, _ = transformer.lm_forward(
            params, cfg, tokens, pos=pos, cache=cache, plain_kernels=plain_kernels)
        return logits, new_cache

    return decode
