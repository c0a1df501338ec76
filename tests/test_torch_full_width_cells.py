"""The full-width configs on ``meta`` (no device, no JAX): every attention
head dim a config's prefill and decode hand the kernels has an instance in
the kernel it reaches, and the dry run's (1, 1) serve trace of the three
cells first served on the card in full (qwen2.5-32b and chameleon-34b at
full depth, kimi-k2 at 1 of 61 layers), whose weight bytes are the
configs' analytic ``param_count`` in bf16 plus what that count leaves
out."""

import dataclasses

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import AbstractMesh
from repro_torch.kernels.decode_attention.ops import HEAD_DIMS as DECODE_HEAD_DIMS
from repro_torch.kernels.flash_attention.ops import HEAD_DIMS as FLASH_HEAD_DIMS
from repro_torch.launch import steps
from repro_torch.launch.cost import nbytes
from repro_torch.models import api, layers

PROMPT, KV = 128, 136  # the serve path's prompt, and its cache after 8 decoded tokens
# the cells' depth on one 80 GB card: kimi-k2's 384 experts take 33.8 GB a
# layer, so a second layer would leave no room for a prefill's dispatch buffer
CELLS = {"qwen2.5-32b": 64, "chameleon-34b": 48, "kimi-k2-1t-a32b": 1}


def _record_head_dims(monkeypatch):
    """Spy on the plain versions the models call with ``plain_kernels``:
    flash's (q/k, v) head dims and paged decode's head dim."""
    seen = {"flash": set(), "decode": set()}
    flash, decode = layers.flash_attention_plain, layers.paged_decode_ref

    def flash_spy(q, k, v, *args, **kwargs):
        seen["flash"].add((q.shape[-1], v.shape[-1]))
        return flash(q, k, v, *args, **kwargs)

    def decode_spy(q, *args):
        seen["decode"].add(q.shape[-1])
        return decode(q, *args)

    monkeypatch.setattr(layers, "flash_attention_plain", flash_spy)
    monkeypatch.setattr(layers, "paged_decode_ref", decode_spy)
    return seen


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_full_width_head_dim_has_a_kernel_instance(arch, monkeypatch):
    """A 16-token prefill and one decode step of the full-width config on
    meta through the models' own attention calls: each head dim they pass
    is one the CUDA kernels are instantiated for (``HEAD_DIMS``), or the
    card raises at the first call."""
    cfg = get_config(arch)
    seen = _record_head_dims(monkeypatch)
    params = api.param_specs(cfg)
    prefill, decode = ShapeConfig("p", 16, 1, "prefill"), ShapeConfig("d", 32, 1, "decode")
    steps.build_prefill_step(cfg, prefill, plain_kernels=True)(params, api.input_specs(cfg, prefill))
    specs = api.input_specs(cfg, decode)
    steps.build_decode_step(cfg, decode, plain_kernels=True)(params, specs["tokens"], specs["cache"], 16)
    assert seen["flash"] <= set(FLASH_HEAD_DIMS), (arch, seen["flash"])
    assert seen["decode"] <= set(DECODE_HEAD_DIMS), (arch, seen["decode"])
    if cfg.family != "rwkv6":
        assert seen["flash"]  # the trace reached the model's attention
    if arch == "kimi-k2-1t-a32b":
        assert seen == {"flash": {(112, 112)}, "decode": {112}}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _cell(arch):
    return dataclasses.replace(get_config(arch), n_layers=CELLS[arch])


@pytest.mark.parametrize("arch", CELLS)
def test_cell_weight_bytes_are_the_analytic_count_in_bf16(arch):
    """Every leaf bf16 but the MoE router (f32), and ``param_count``
    counts every leaf but the norm scales and the qkv biases."""
    cfg = _cell(arch)
    leaves = dict(_leaves(api.param_specs(cfg)))
    uncounted = sum(nbytes(t) for name, t in leaves.items()
                    if name.rsplit("/", 1)[-1].endswith("norm") or name.rsplit("/", 1)[-1] in ("bq", "bk", "bv"))
    router_f32 = sum(t.numel() * 2 for name, t in leaves.items() if name.endswith("router"))
    assert {t.dtype for name, t in leaves.items() if not name.endswith("router")} == {torch.bfloat16}
    assert sum(nbytes(t) for t in leaves.values()) == 2 * cfg.param_count() + uncounted + router_f32
    assert (router_f32 > 0) == (cfg.family == "moe")


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", CELLS)
def test_serve_trace_of_the_full_width_cells(arch, kind):
    """``lower_cell`` at mesh (1, 1) on the serve path's shapes (B 1, a
    128-token prefill, a decode step over 136 cached tokens): arguments
    are the weights and the inputs, byte for byte; the predicted peak
    holds them; kimi-k2's prefill counts its dropless dispatch buffer,
    (1, 384, C = S·k = 1024, 7168) bf16, among the temporaries."""
    cfg = _cell(arch)
    shape = ShapeConfig(f"serve_{kind}", PROMPT if kind == "prefill" else KV, 1, kind)
    mem = steps.lower_cell(AbstractMesh((1, 1), ("data", "model")), cfg, shape).memory_analysis()
    weights = sum(nbytes(t) for t in dict(_leaves(api.param_specs(cfg))).values())
    if kind == "prefill":
        inputs = PROMPT * 4  # int32 tokens
    else:
        cache = sum(nbytes(t) for t in api.cache_specs(cfg, 1, KV).values())
        inputs = 4 + cache + 4  # one token, the cache, pos
    assert mem["argument_size_in_bytes"] == weights + inputs
    assert mem["peak_bytes_per_device"] >= weights + inputs
    if arch == "kimi-k2-1t-a32b" and kind == "prefill":
        assert mem["temp_size_in_bytes"] >= 384 * (PROMPT * 8) * 7168 * 2
