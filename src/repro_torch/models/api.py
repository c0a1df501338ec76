"""Model API with the reference's call shapes, for every family (dense with
GQA or MLA attention, moe, rwkv6, hybrid, encdec):

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
"""

from __future__ import annotations

from . import encdec, transformer
from ..configs.base import ModelConfig


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
