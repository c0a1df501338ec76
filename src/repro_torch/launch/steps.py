"""Step builders: one (train | prefill | decode) step per (architecture x
shape), the reference's ``launch/steps.py``.

The builders return plain functions, as the reference's do.  The
counterpart of the reference's ``jax.jit`` is ``capture`` (defined in
``repro_torch.graphs``, and importable from here): on a CUDA device it
turns a step into one CUDA graph replayed on every call; on the CPU it
returns the step itself.

The reference's sharding helpers (``fsdp_axes_for``, ``*_shardings``,
``train_abstract_inputs``, ``lower_cell``) wait for the port's
``distributed/`` package: the port runs on one device.  The train step
stays eager (its device is busy; there is little host time for a graph to
save).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..configs.base import ModelConfig, ShapeConfig
from ..graphs import CapturedStep, capture  # noqa: F401  (the jit counterpart, with the builders)
from ..models import api
from ..training import loop, optim


def opt_config_for(cfg: ModelConfig) -> optim.OptimizerConfig:
    """1T-class archs get bf16 first moment + factored second moment
    (fp32 AdamW state alone would be 8 TB)."""
    big = cfg.param_count() > 50e9
    return optim.OptimizerConfig(
        moment_dtype="bfloat16" if big else "float32",
        factored_second_moment=big,
    )


def _train_cfg(cfg: ModelConfig) -> ModelConfig:
    """remat on; ``seq_shard`` is set as the reference sets it and is a
    sharding hint the single-device port does not read."""
    return dataclasses.replace(cfg, remat=True, seq_shard=True)


# ------------------------------------------------------------------ train
def build_train_step(cfg: ModelConfig, ocfg: Optional[optim.OptimizerConfig] = None):
    """-> (train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), ocfg): ``training/loop.make_train_step`` on the remat config,
    eager, updating params and state in place."""
    cfg = _train_cfg(cfg)
    ocfg = ocfg or opt_config_for(cfg)
    return loop.make_train_step(cfg, ocfg), ocfg


# ---------------------------------------------------------------- prefill
def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig):
    """prefill_step(params, inputs) -> (last-token logits (B, V), cache):
    a fresh cache of ``shape.seq_len`` slots on the tokens' device,
    prefilled at 0."""
    pfn = api.prefill_fn(cfg)
    B, S = shape.global_batch, shape.seq_len

    def prefill_step(params, inputs):
        cache = api.init_cache(cfg, B, S, inputs["tokens"].device)
        logits, cache = pfn(params, inputs, cache, 0)
        return logits[:, -1, :], cache

    return prefill_step


# ----------------------------------------------------------------- decode
def build_decode_step(cfg: ModelConfig, shape: ShapeConfig, plain_kernels: bool = False):
    """decode_step(params, tokens (B,1), cache, pos) -> (logits (B, V),
    cache), the cache updated in place; ``pos`` an int or a 0-d integer
    tensor on the model's device (what a captured step takes).  ``shape``
    sizes the reference's shardings and nothing here."""
    del shape
    dfn = api.decode_fn(cfg, plain_kernels)

    def decode_step(params, tokens, cache, pos):
        logits, cache = dfn(params, tokens, cache, pos)
        return logits[:, -1, :], cache

    return decode_step
