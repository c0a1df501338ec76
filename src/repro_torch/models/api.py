"""Model API with the reference's call shapes, for every family (dense with
GQA or MLA attention, moe, rwkv6, hybrid, encdec):

  param_specs(cfg)                               abstract params (meta tensors)
  init_params(cfg, key, device)                  params on ``device``
  init_cache(cfg, batch, max_seq, device)        k/v caches and recurrent states
  loss_fn(cfg)(params, batch)                    -> (loss, {"ce", "aux"})
  prefill_fn(cfg)(params, inputs, cache, pos)    -> (logits, cache)
  decode_fn(cfg)(params, tokens, cache, pos)     -> (logits (B,1,V), cache)

A decode step's ``pos`` is an int or a 0-d integer tensor on the model's
device (the reference's traced scalar): with a tensor the step reads no
host value, so a captured CUDA graph (``repro_torch.graphs.capture``) replays
it at whatever position the tensor holds.  Prefill takes an int.

``key`` is an int seed or a ``torch.Generator`` whose ``initial_seed()`` is
used.  ``device`` defaults to ``cuda``; the CPU runs only when asked for.
``plain_kernels=True`` runs every kernel's plain PyTorch version instead of
the kernel, which is how a run on the card is held against the plain path.

``param_specs``, ``cache_specs`` and ``input_specs`` are the reference's
ShapeDtypeStruct stand-ins: trees of tensors on the ``meta`` device, with
shapes and dtypes and no storage, which the sharding rules read.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import encdec, transformer
from ..configs.base import ModelConfig, ShapeConfig
from .common import Spec

META = torch.device("meta")


def _meta(template):
    if isinstance(template, Spec):
        return torch.empty(template.shape, dtype=template.dtype, device=META)
    return {k: _meta(v) for k, v in template.items()}


def param_specs(cfg: ModelConfig):
    transformer.require_ported(cfg)
    if cfg.family == "encdec":
        return _meta(encdec.build_encdec_template(cfg))
    return _meta(transformer.build_lm_template(cfg))


def _seed(key) -> int:
    return int(key.initial_seed()) if hasattr(key, "initial_seed") else int(key)


def init_params(cfg: ModelConfig, key=0, device="cuda"):
    if cfg.family == "encdec":
        return encdec.encdec_init(cfg, _seed(key), device)
    return transformer.lm_init(cfg, _seed(key), device)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda"):
    if cfg.family == "encdec":
        return encdec.encdec_init_cache(cfg, batch, max_seq, device)
    return transformer.init_cache(cfg, batch, max_seq, device)


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int):
    """The cache ``init_cache`` allocates, as meta tensors: the reference's
    leaves, with the sequence dims rounded up to whole decode pages
    (``transformer.cache_len``), so equal to the reference's shapes when
    ``max_seq`` (and whisper's ``enc_frames``) is a multiple of the page."""
    return init_cache(cfg, batch, max_seq, META)


def loss_fn(cfg: ModelConfig, plain_kernels: bool = False):
    """(params, batch) -> (loss, {"ce", "aux"}): ``batch`` holds tokens and
    labels (B, S), labels < 0 masked, and frames (B, enc_frames, d_model)
    for encdec.  The kernels have no backward, so on CUDA a loss that is
    differentiated needs ``plain_kernels=True``: with the kernels, an input
    that requires grad under grad mode raises (``kernels/_build.run_on``)."""
    transformer.require_ported(cfg)
    if cfg.family == "encdec":
        return lambda params, batch: encdec.encdec_loss(params, cfg, batch, plain_kernels)
    return lambda params, batch: transformer.lm_loss(params, cfg, batch, plain_kernels=plain_kernels)


def prefill_fn(cfg: ModelConfig, plain_kernels: bool = False):
    """(params, inputs, cache, pos) -> (logits, cache).  ``inputs`` is the
    batch dict with ``tokens`` (B, S), and for encdec ``frames`` (B,
    enc_frames, d_model), which are encoded on every call."""
    transformer.require_ported(cfg)
    if cfg.family == "encdec":

        def prefill(params, inputs, cache, pos=0):
            memory = encdec.encode(params, cfg, inputs["frames"], plain_kernels)
            return encdec.decode_forward(params, cfg, inputs["tokens"], memory=memory, pos=pos, cache=cache,
                                         plain_kernels=plain_kernels)

        return prefill

    def prefill(params, inputs, cache, pos=0):
        logits, new_cache, _ = transformer.lm_forward(
            params, cfg, inputs["tokens"], pos=pos, cache=cache, plain_kernels=plain_kernels)
        return logits, new_cache

    return prefill


def decode_fn(cfg: ModelConfig, plain_kernels: bool = False):
    """(params, tokens (B,1), cache, pos) -> (logits (B,1,V), cache); ``pos``
    an int or a 0-d integer tensor on the model's device."""
    transformer.require_ported(cfg)
    if cfg.family == "encdec":

        def decode(params, tokens, cache, pos):
            return encdec.decode_forward(params, cfg, tokens, memory=None, pos=pos, cache=cache,
                                         plain_kernels=plain_kernels)

        return decode

    def decode(params, tokens, cache, pos):
        logits, new_cache, _ = transformer.lm_forward(
            params, cfg, tokens, pos=pos, cache=cache, plain_kernels=plain_kernels)
        return logits, new_cache

    return decode


# ------------------------------------------------------------- input specs
def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """Meta-tensor stand-ins for one (arch x shape) cell.  Decode cells
    carry the KV cache (seq_len of context) as an input."""
    B, S = shape.global_batch, shape.seq_len

    def t(dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device=META)

    if shape.kind in ("train", "prefill"):
        specs = {"tokens": t((B, S))}
        if shape.kind == "train":
            specs["labels"] = t((B, S))
        if cfg.family == "encdec":
            specs["frames"] = t((B, cfg.enc_frames, cfg.d_model), torch.bfloat16)
        return specs
    # decode: one new token against a cache of S context tokens
    return {"tokens": t((B, 1)), "cache": cache_specs(cfg, B, S)}
