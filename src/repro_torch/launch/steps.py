"""Step builders: one (train | prefill | decode) step per (architecture x
shape), the reference's ``launch/steps.py``.

The builders return plain functions, as the reference's do.  The
counterpart of the reference's ``jax.jit`` is ``capture`` (defined in
``repro_torch.graphs``, and importable from here): on a CUDA device it
turns a step into one CUDA graph replayed on every call; on the CPU it
returns the step itself.

The sharding helpers (``fsdp_axes_for``, ``train_abstract_inputs``,
``*_shardings``) resolve each step's input and output shardings from
``distributed.sharding`` for any mesh, a ``DeviceMesh`` or an
``AbstractMesh``; they read the meta-tensor specs of ``models.api`` and
``training.optim``.  The reference's ``lower_cell`` (lowering a step under
its shardings for the dry run) waits for the dry-run slice.  The train step
stays eager (its device is busy; there is little host time for a graph to
save).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..configs.base import ModelConfig, ShapeConfig
from ..distributed import sharding as shd
from ..distributed.sharding import P, NamedSharding
from ..graphs import CapturedStep, capture  # noqa: F401  (the jit counterpart, with the builders)
from ..models import api
from ..training import loop, optim

# archs big enough that ZeRO-3 must span the pod axis too (1T params)
FSDP_POD_ARCHS = {"kimi-k2-1t-a32b"}


def fsdp_axes_for(cfg: ModelConfig, mesh) -> Tuple[str, ...]:
    if cfg.name.split("-smoke")[0] in FSDP_POD_ARCHS and "pod" in shd.axis_sizes(mesh):
        return ("pod", "data")
    return ("data",)


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
    sharding hint the port's models do not read (they have no sharding
    constraints yet)."""
    return dataclasses.replace(cfg, remat=True, seq_shard=True)


# ------------------------------------------------------------------ train
def build_train_step(cfg: ModelConfig, ocfg: Optional[optim.OptimizerConfig] = None):
    """-> (train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), ocfg): ``training/loop.make_train_step`` on the remat config,
    eager, updating params and state in place."""
    cfg = _train_cfg(cfg)
    ocfg = ocfg or opt_config_for(cfg)
    return loop.make_train_step(cfg, ocfg), ocfg


def train_abstract_inputs(cfg: ModelConfig, shape: ShapeConfig, ocfg: optim.OptimizerConfig):
    p_specs = api.param_specs(cfg)
    return p_specs, optim.state_specs(ocfg, p_specs), api.input_specs(cfg, shape)


def train_shardings(mesh, cfg: ModelConfig, shape: ShapeConfig, ocfg: optim.OptimizerConfig):
    """-> ((params, opt state, batch), (params, opt state, metrics)) shardings;
    metrics None (scalars, left to the step)."""
    fsdp = fsdp_axes_for(cfg, mesh)
    p_specs, o_specs, in_specs = train_abstract_inputs(cfg, shape, ocfg)
    p_sh = shd.param_shardings(mesh, p_specs, fsdp)
    o_sh = shd.opt_state_shardings(mesh, o_specs, p_sh)
    b_sh = shd.batch_shardings(mesh, in_specs)
    return (p_sh, o_sh, b_sh), (p_sh, o_sh, None)


def _logits_sharding(mesh, cfg: ModelConfig, shape: ShapeConfig):
    return NamedSharding(mesh, shd.filter_spec(P(shd.BATCH, "model"), mesh, (shape.global_batch, cfg.vocab_size)))


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


def prefill_shardings(mesh, cfg: ModelConfig, shape: ShapeConfig):
    """-> ((params, inputs), (last-token logits, cache)) shardings."""
    fsdp = fsdp_axes_for(cfg, mesh)
    p_sh = shd.param_shardings(mesh, api.param_specs(cfg), fsdp)
    in_sh = shd.batch_shardings(mesh, api.input_specs(cfg, shape))
    c_specs = api.cache_specs(cfg, shape.global_batch, shape.seq_len)
    c_sh = shd.cache_shardings(mesh, c_specs, cfg)
    return (p_sh, in_sh), (_logits_sharding(mesh, cfg, shape), c_sh)


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


def decode_shardings(mesh, cfg: ModelConfig, shape: ShapeConfig):
    """-> ((params, tokens, cache, pos), (last-token logits, cache)) shardings."""
    fsdp = fsdp_axes_for(cfg, mesh)
    p_sh = shd.param_shardings(mesh, api.param_specs(cfg), fsdp)
    specs = api.input_specs(cfg, shape)
    tok_sh = shd.batch_shardings(mesh, specs["tokens"])
    c_sh = shd.cache_shardings(mesh, specs["cache"], cfg)
    pos_sh = NamedSharding(mesh, P())
    return (p_sh, tok_sh, c_sh, pos_sh), (_logits_sharding(mesh, cfg, shape), c_sh)
