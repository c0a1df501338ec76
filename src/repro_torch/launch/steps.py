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
``training.optim``.  ``build_train_step`` gives the train step captured
at its first call on a CUDA device (``graphs.capture_at_first_call``), as
the reference's lowers a jitted one; under a mesh it stays eager.

``lower_cell`` is the reference's dry-run lowering: where the reference
lowers a step under its shardings for a mesh of host devices, the port
runs the same step once, on ``meta`` tensors, as rank 0 of a fake process
group of the mesh's size (``launch.mesh.fake_mesh``) under
``models.common.tensor_parallel``, with the cost counter of
``launch.cost`` counting every op and collective it dispatches.  No
device and no CUDA is used: a ``LoweredCell`` is a plan, made where the
process runs.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..distributed import sharding as shd
from ..distributed.sharding import P, NamedSharding
from ..graphs import CapturedStep, capture  # noqa: F401  (the jit counterpart, with the builders)
from ..graphs import capture_at_first_call
from ..models import api
from ..models.common import splits_sequence, tensor_parallel, tree_leaves
from ..training import loop, optim
from . import cost
from .mesh import CARDS_PER_HOST, fake_mesh

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
    """remat on, and ``seq_shard`` on, as the reference sets them: under a
    ``model`` axis over 1 that divides S, the dense and moe forwards hold
    each rank's ``S / model`` rows of the residual stream between blocks
    (``models.common.splits_sequence``), and remat saves those rows."""
    return dataclasses.replace(cfg, remat=True, seq_shard=True)


# ------------------------------------------------------------------ train
def build_train_step(cfg: ModelConfig, ocfg: Optional[optim.OptimizerConfig] = None, mesh=None):
    """-> (train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), ocfg): ``training/loop.make_train_step`` on the remat config,
    updating params and state in place.  Without ``mesh`` it is captured
    at its first call on CUDA tensors, params and state held
    (``graphs.capture_at_first_call``: its first two calls the warm calls,
    then one graph replayed), and runs as it is on the CPU and ``meta``;
    under ``mesh`` (a ``DeviceMesh``) it is eager, data- and
    tensor-parallel, ``batch`` the global batch."""
    cfg = _train_cfg(cfg)
    ocfg = ocfg or opt_config_for(cfg)
    step = loop.make_train_step(cfg, ocfg, mesh)
    return (step if mesh is not None else capture_at_first_call(step, held=(0, 1))), ocfg


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
def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig, plain_kernels: bool = False):
    """prefill_step(params, inputs) -> (last-token logits (B, V), cache):
    a fresh cache of ``shape.seq_len`` slots for the tokens' B rows (the
    global batch, or a rank's rows of it) on their device, prefilled at
    0.  ``plain_kernels`` runs the kernels' plain versions."""
    pfn = api.prefill_fn(cfg, plain_kernels)
    S = shape.seq_len

    def prefill_step(params, inputs):
        tokens = inputs["tokens"]
        cache = api.init_cache(cfg, tokens.shape[0], S, tokens.device)
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


# ------------------------------------------------------------- cell lowering
@dataclasses.dataclass
class LoweredCell:
    """One (arch x shape) step traced as rank 0 of a mesh (``lower_cell``):
    the port's counterpart of a compiled ``Lowered``.

    ``totals`` are the cost counter's (``launch.cost``) for the step on
    rank 0.  ``argument_bytes`` are the step's arguments as the sharding
    rules lay them out on rank 0 (``*_shardings`` at coordinate 0): the
    reference's ``argument_size_in_bytes``.  ``held_argument_bytes`` are
    what the port's step holds: every parameter and optimizer leaf whole,
    the cache's leaves whole but for their batch rows.  ``output_bytes``
    and ``alias_bytes`` are the outputs and those of them that are
    arguments updated in place (parameters and optimizer state in a train
    step, the cache in decode), each in the rules' layout;
    ``temp_bytes`` the most bytes the step's own storages held at once,
    less the new outputs'.  ``seq_shard`` is True where the traced step
    held the residual stream split over sequence
    (``models.common.splits_sequence``: a train step of the dense or moe
    family under a ``model`` axis over 1 that divides S)."""

    lower_s: float
    totals: cost.CostTotals
    argument_bytes: int
    held_argument_bytes: int
    output_bytes: int
    alias_bytes: int
    temp_bytes: int
    seq_shard: bool = False

    def memory_analysis(self) -> Dict[str, int]:
        """The reference's ``memory_analysis`` keys; ``peak_bytes_per_device``
        by its formula (``launch/dryrun.py``), and ``held_peak_bytes`` by
        the same formula on the held arguments; and the counter's
        ``saved_for_backward_bytes`` (what remat keeps from the forward)
        and ``peak_at_op`` (the op whose output set the peak, and its
        place among the step's ops)."""
        out = {"argument_size_in_bytes": self.argument_bytes, "output_size_in_bytes": self.output_bytes,
               "temp_size_in_bytes": self.temp_bytes, "alias_size_in_bytes": self.alias_bytes,
               "generated_code_size_in_bytes": 0}
        extra = self.output_bytes + self.temp_bytes - self.alias_bytes
        out["peak_bytes_per_device"] = self.argument_bytes + extra
        out["held_argument_size_in_bytes"] = self.held_argument_bytes
        out["held_peak_bytes"] = self.held_argument_bytes + extra
        out["saved_for_backward_bytes"] = self.totals.saved_bytes
        out["peak_at_op"] = f"{self.totals.peak_op}, op {self.totals.peak_op_index} of {self.totals.ops}"
        return out


def _rank0_bytes(shardings, specs) -> int:
    """Bytes of rank 0's shards (mesh coordinate 0) of a tree of tensors."""
    total = 0
    for sh, t in zip(tree_leaves(shardings), tree_leaves(specs)):
        sl = next(iter(sh.shard_slices(tuple(t.shape)).values()))  # coordinate (0, ..., 0) comes first
        total += math.prod(len(range(*s.indices(n))) for s, n in zip(sl, t.shape)) * t.element_size()
    return total


def _rank0_rows(sharding, t):
    """Rank 0's rows (dim 0) of ``t`` under a batch sharding."""
    return next(iter(sharding.shard_slices(tuple(t.shape)).values()))[0]


def _held(trees) -> int:
    """Bytes of every tensor of a sequence of trees."""
    return sum(cost.nbytes(t) for tree in trees for t in tree_leaves(tree))


def lower_cell(mesh, cfg: ModelConfig, shape: ShapeConfig) -> LoweredCell:
    """Trace one (arch x shape) cell's step as rank 0 of ``mesh`` (an
    ``AbstractMesh``, or anything with ``shape`` and ``mesh_dim_names``):
    the train step of ``build_train_step`` (remat, AdamW at
    ``opt_config_for``), the prefill of ``build_prefill_step`` or the
    decode of ``build_decode_step``, each with ``plain_kernels``, on meta
    tensors under the cost counter, in a fake process group of the mesh's
    size (``launch.mesh.fake_mesh``) and ``tensor_parallel`` of its mesh.
    Rank 0 takes its rows of the global batch (all of them where the batch
    axes do not divide it) and the first part of every split, which is
    the largest of an uneven one: its counts are the per-device maximum.
    A mesh of one card runs the one-card train step (no gradient
    reduction).  Opens and closes this process's default process group."""
    kind = shape.kind
    t0 = time.perf_counter()
    with fake_mesh(mesh) as dm:
        counter = cost.CostCounter(cost.axes_of(dm), CARDS_PER_HOST)
        p = api.param_specs(cfg)
        if kind == "train":
            step, ocfg = build_train_step(cfg, mesh=dm if dm.size() > 1 else None)
            tcfg = _train_cfg(cfg)
            (p_sh, o_sh, b_sh), _ = train_shardings(mesh, tcfg, shape, ocfg)
            _, o, batch = train_abstract_inputs(tcfg, shape, ocfg)
            args = (p, o, batch)
            argument = _rank0_bytes(p_sh, p) + _rank0_bytes(o_sh, o) + _rank0_bytes(b_sh, batch)
            alias = _rank0_bytes(p_sh, p) + _rank0_bytes(o_sh, o)
            held = _held(args)
            with counter:
                _, _, metrics = step(*args)
            new = [metrics]
        elif kind == "prefill":
            step = build_prefill_step(cfg, shape, plain_kernels=True)
            (p_sh, in_sh), _ = prefill_shardings(mesh, cfg, shape)
            specs = api.input_specs(cfg, shape)
            inputs = {k: v[_rank0_rows(in_sh[k], v)] for k, v in specs.items()}
            argument = _rank0_bytes(p_sh, p) + _rank0_bytes(in_sh, specs)
            alias = 0
            held = _held((p, inputs))
            with counter, tensor_parallel(dm):
                new = step(p, inputs)
        else:
            step = build_decode_step(cfg, shape, plain_kernels=True)
            (p_sh, tok_sh, c_sh, pos_sh), _ = decode_shardings(mesh, cfg, shape)
            specs = api.input_specs(cfg, shape)
            rows = _rank0_rows(tok_sh, specs["tokens"])
            tokens = specs["tokens"][rows]
            cache = {k: v[:, rows] for k, v in specs["cache"].items()}
            pos = torch.empty((), dtype=torch.int32, device=api.META)
            argument = (_rank0_bytes(p_sh, p) + _rank0_bytes(tok_sh, specs["tokens"])
                        + _rank0_bytes(c_sh, specs["cache"]) + _rank0_bytes(pos_sh, pos))
            alias = _rank0_bytes(c_sh, specs["cache"])
            held = _held((p, tokens, cache, pos))
            with counter, tensor_parallel(dm):
                logits, _ = step(p, tokens, cache, pos)
            new = [logits]
        new_bytes = _held(new)
        model = shd.axis_sizes(mesh).get("model", 1) if dm.size() > 1 else 1
        return LoweredCell(
            lower_s=time.perf_counter() - t0, totals=counter.totals,
            argument_bytes=argument, held_argument_bytes=held, output_bytes=alias + new_bytes,
            alias_bytes=alias, temp_bytes=max(0, counter.totals.peak_live_bytes - new_bytes),
            seq_shard=kind == "train" and splits_sequence(_train_cfg(cfg), shape.seq_len, model, cached=False))
