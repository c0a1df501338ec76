"""The frozen FLOP and byte counts against hand counts, and the weights'
tree against the program's parameter template."""

import pytest
import torch

from kvbench import arch, roofline, weights
from kvbench.arch import dense_gqa
from kvbench.cell import HERE, ROOT, load_json

GLM = load_json(HERE / "configs" / "glm4-9b.json")["model"]
QWEN = load_json(HERE / "configs" / "qwen3-14b.json")["model"]
CONFIGS = {c["name"]: c["file"] for c in load_json(ROOT / "BENCHMARK.json")["configs"]}


def test_prefill_flops_by_hand():
    # glm4-9b at 4096 tokens, one layer: q and o 2·S·4096·4096 each, k and v
    # 2·S·4096·256 each, the MLP 3·2·S·4096·13696, attention 4·32·128·S(S+1)/2
    S = 4096
    layer = 2 * S * 4096 * 4096 * 2 + 2 * S * 4096 * 256 * 2 + 6 * S * 4096 * 13696 + 4 * 32 * 128 * S * (S + 1) // 2
    assert roofline.prefill_flops(GLM, S) == pytest.approx(40 * layer + 2 * 4096 * 151552)
    assert 7.0e13 < roofline.prefill_flops(GLM, S) < 7.5e13


def test_decode_step_by_hand():
    # qwen3-14b: 40 layers of 5120² q and o, 5120·1024 k and v, 3·5120·17408
    # MLP, two norms and the QK-norm scales; the 5120 x 151936 head
    per_layer = 5120 * 5120 * 2 + 5120 * 1024 * 2 + 3 * 5120 * 17408 + 2 * 5120 + 2 * 128
    kv = 1280
    flops, nbytes = roofline.decode_step(QWEN, kv)
    assert nbytes == 2 * (40 * per_layer + 5120 * 151936 + 2 * 5120) + 2 * 40 * 2 * 8 * 128 * (kv + 1)
    assert flops == pytest.approx(40 * (2 * (per_layer - 2 * 5120 - 256) + 4 * 40 * 128 * kv) + 2 * 5120 * 151936)
    assert roofline.bound_s(flops, nbytes)[1] == "bytes"
    assert 8.3e-3 < roofline.bound_s(flops, nbytes)[0] < 8.5e-3


def test_kernel_calls_by_hand():
    f, b = roofline.flash_call(GLM, 4096)
    assert f == 4 * 32 * 128 * 4096 * 4097 // 2
    assert b == 2 * (2 * 4096 * 32 * 128 + 2 * 4096 * 2 * 128)
    f, b = roofline.paged_decode_call(QWEN, 1100)
    assert f == 4 * 40 * 128 * 1100
    assert b == 2 * 2 * 40 * 128 + 2 * 2 * 1100 * 8 * 128 + 4 * 69 + 4


@pytest.mark.parametrize("name", list(CONFIGS))
def test_weights_match_the_program_template(name):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.models.common import tree_flatten

    conf = load_json(ROOT / CONFIGS[name])
    mod = arch.of(conf)
    cfg = dataclasses.replace(get_config(conf["port_config"]), **conf.get("port_overrides", {}))
    specs = api.param_specs(cfg)
    mine = mod.shapes(conf["model"])
    flat_specs, def_specs = tree_flatten(specs)
    flat_mine, def_mine = tree_flatten(mine, is_leaf=lambda t: isinstance(t, tuple))
    assert def_specs == def_mine
    assert [tuple(t.shape) for t in flat_specs] == list(flat_mine)
    assert weights.count(mod, conf["model"]) == sum(t.numel() for t in flat_specs)


def test_weights_seeded_and_scaled():
    m = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_head": 16, "d_ff": 128,
         "vocab_size": 256, "qk_norm": True, "qkv_bias": True}
    a, b = weights.make(dense_gqa, m, 2**31 + 9, "cpu"), weights.make(dense_gqa, m, 2**31 + 9, "cpu")
    assert torch.equal(a["blocks"]["mlp"]["w_up"], b["blocks"]["mlp"]["w_up"])
    assert a["embed"].dtype == torch.bfloat16
    assert torch.equal(a["blocks"]["attn"]["q_norm"], torch.ones(2, 16, dtype=torch.bfloat16))
    std = a["blocks"]["mlp"]["w_down"].float().std().item()
    assert 0.7 * 128 ** -0.5 < std < 1.3 * 128 ** -0.5
