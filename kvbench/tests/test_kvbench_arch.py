"""The architecture modules (``kvbench/arch/``): the harness reads the
dense GQA cells as it did before the modules existed, and a second
architecture arrives as new files only.

The recorded values were read from the harness before ``kvbench/arch/``
existed (``weights.make``, ``check.kv_numbers``, ``check.decode_numbers``,
``roofline`` and ``engine_loop``'s block size on the same inputs), on the
CPU; they hold bit for bit."""

import hashlib
import json
import os
import sys
import types

import pytest
import torch

from kvbench import arch, check, weights
from kvbench import cell as cellmod
from kvbench import run as kvrun
from kvbench.arch import dense_gqa
from kvbench.cell import HERE, ROOT, load_json
from kvbench.runners import engine_loop
from kvbench.tests.smoke import smoke_cell, smoke_config

BENCH = load_json(ROOT / "BENCHMARK.json")
CONFIGS = [c["name"] for c in BENCH["configs"]]
CELLS = [w["name"] for w in BENCH["workloads"]]

# (a) SHA-256 of each leaf's bytes, weights.make at the smoke size, seed 0
WEIGHTS = {
    "glm4-9b": {
        "blocks.attn.bk": "2c7634d1e2af709c1b08e743329fbdd4fceaa105c8e3c424d59d82b66aa2ddaa",
        "blocks.attn.bq": "58fa27ed119bc5c63c96bbd67f2511549b53325f41787bad7efeab261f9a22ab",
        "blocks.attn.bv": "15fc050a4dc29246fe6dd79bca434f15fedaf800dd7eb688f105a74dd922d086",
        "blocks.attn.wk": "80c599a5ff7410e2ffdcf9e38a605838a9128cf81c381a19a08354d82c54a417",
        "blocks.attn.wo": "49435ae4a5ad39658ce98b438df32d4775edea6d70eb51614b7e1305f78182f9",
        "blocks.attn.wq": "dceae2099f3150670519f718f6b815373ac20741b3e795be6b731d6cb93a0e81",
        "blocks.attn.wv": "9c762def23f2608d66d59ea302721086960f924dc7ef88513d2fc3ff17cc9420",
        "blocks.attn_norm": "1ede9ebfa1ad011b89a3e3df648a958674d64afa0726d98858a68b8a4da14ee0",
        "blocks.mlp.w_down": "a9cbe7c5c8fae7fd1906e22a9418a72052d5838e3521c0671c0ac05a6c81a180",
        "blocks.mlp.w_gate": "7aafe06759ef453a496f1107afeab5b184a9e3ed1cc33ad4ef8fd7d9d4922b37",
        "blocks.mlp.w_up": "4bb85adef1cf2e0a6598ebcf8c383abbe8f26374b69dfc8a15467c3dc21c92c7",
        "blocks.mlp_norm": "1ede9ebfa1ad011b89a3e3df648a958674d64afa0726d98858a68b8a4da14ee0",
        "embed": "10b11e1a0efaaa19fb1c4cb78b6763c9faf570624d138eb8426e10008b4f8ba2",
        "final_norm": "e72710531b01d91ee76a2457cdc9c6c89a197db47da8ebd4ae672e13ddd668cd",
        "lm_head": "2749ca12bcfdcf8bae14777753d1edc814b80df1a41adbe0ee3b6c3a97baa46e",
    },
    "qwen3-14b": {
        "blocks.attn.k_norm": "26ab507cf4bbb401acc7bebf555f8cd2130512b6c6ba2eb38e94aafcaeae114a",
        "blocks.attn.q_norm": "26ab507cf4bbb401acc7bebf555f8cd2130512b6c6ba2eb38e94aafcaeae114a",
        "blocks.attn.wk": "4f1e28d9cd0061edff8da629cee92a9d2b954785783015b425907f2523d95833",
        "blocks.attn.wo": "352a9a74b3f317d90d49e8169c7e61a0784d4a86ea14bb7123c239a2a814f9aa",
        "blocks.attn.wq": "4a5176f8d54f82e3f09a0b5fca3f114e93fe2ad7f2d57859782fd6ce53eee7c1",
        "blocks.attn.wv": "c3758c7c35bf150f9635bb4ad3b98a30e91f1f7fa56c135bcb4ec633c68570ba",
        "blocks.attn_norm": "1ede9ebfa1ad011b89a3e3df648a958674d64afa0726d98858a68b8a4da14ee0",
        "blocks.mlp.w_down": "4f4bc8462dc94e39267767b005001a90e156ab7f88d00ba1dec0d2a115c97c4c",
        "blocks.mlp.w_gate": "980fb1a036882d189fbeb1e077aefd519306367da986b30e37c07eb223bd8aff",
        "blocks.mlp.w_up": "3a504d604d989eec96afebf4dbc57fc8f993cac6a271ec29659a631ffaf9af9c",
        "blocks.mlp_norm": "1ede9ebfa1ad011b89a3e3df648a958674d64afa0726d98858a68b8a4da14ee0",
        "embed": "a665c901e36fe9d991c1e8372d1cd8d824b87de2fc5330690d278c11d5a1e667",
        "final_norm": "e72710531b01d91ee76a2457cdc9c6c89a197db47da8ebd4ae672e13ddd668cd",
        "lm_head": "18b734ef326d26aad6ffab6fe7d193022377230c1e90a9201b7cdc86204d3f36",
    },
}

# (b) check.kv_numbers and check.decode_numbers on the planted samples below
KV = {
    "glm4-9b": {"program": {"kv_fresh_err": 0.0011688038939610124, "kv_promoted_err": 0.0011776527389883995},
                "control": {"kv_fresh_err": 0.2221173197031021, "kv_promoted_err": 0.11504563689231873}},
    "qwen3-14b": {"program": {"kv_fresh_err": 0.0011652149260044098, "kv_promoted_err": 0.0014361797366291285},
                  "control": {"kv_fresh_err": 0.2136036604642868, "kv_promoted_err": 0.13110575079917908}},
}
DECODE = {
    "glm4-9b": {"program": {"decode_gap": 0.21499954164028168, "decode_logit_err": 0.03635036200284958},
                "control": {"decode_gap": 0.2314995974302292, "decode_logit_err": 0.447147935628891}},
    "qwen3-14b": {"program": {"decode_gap": 0.48450616002082825, "decode_logit_err": 0.03824017196893692},
                  "control": {"decode_gap": 0.04038740694522858, "decode_logit_err": 0.5293304324150085}},
}

# (c) the operations and bytes at each cell's own shapes, and the block's bytes
SHAPES = {
    "glm4-9b.docqa-hot": {"prefill_flops": {4096: 72329832955904.0},
                          "flash_call": {4096: (137472507904.0, 71303168.0)}, "block_bytes": 655360},
    "glm4-9b.docqa-disk": {"prefill_flops": {2048: 34791147700224.0},
                           "flash_call": {2048: (34376515584.0, 35651584.0)}, "block_bytes": 655360},
    "qwen3-14b.decode-long": {"decode_step": {1025: (28819619840.0, 28148899840.0),
                                              1536: (29238231040.0, 28232622080.0)},
                              "paged_decode_call": {1025: (20992000.0, 4219144.0), 1536: (31457280.0, 6312324.0)},
                              "block_bytes": 2621440},
}


def leaf_hashes(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(leaf_hashes(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = hashlib.sha256(v.contiguous().view(torch.int16).numpy().tobytes()).hexdigest()
    return out


def kv_sample(mod, params, model, block=16, S=48, reused=(16, 32)):
    """Two prompts, their reference keys (a little noise added) and values
    stored as the program stores them, split at each one's reuse."""
    from repro_torch.serving.real_prefill import fortran_blocks

    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, model["vocab_size"], (len(reused), S), generator=g)
    ks, vs = [], []
    mod.forward(params, model, tokens, on_state=lambda i, p: (ks.append(p["k"]), vs.append(p["v"])))
    samples = []
    for b, r in enumerate(reused):
        k = torch.stack([x[b] for x in ks]) + 1e-3 * torch.randn(len(ks), *ks[0].shape[1:], generator=g)
        v = torch.stack([x[b] for x in vs])
        stored = list(torch.cat([fortran_blocks(k.half(), block), fortran_blocks(v.half(), block)], dim=2).numpy())
        samples.append({"tokens": tokens[b].tolist(), "reused": r, "fresh": stored[r // block:],
                        "promoted": stored[: r // block]})
    return samples


def decode_sample(mod, params, model, P=16, n=4):
    """Two requests: the reference's logits with noise as the program's, its
    argmax served but at one step its second best."""
    g = torch.Generator().manual_seed(6)
    V = model["vocab_size"]
    samples = []
    for _ in range(2):
        prompt = torch.randint(0, V, (P,), generator=g).tolist()
        fed = torch.randint(0, V, (n,), generator=g).tolist()
        ref = mod.forward(params, model, torch.tensor([prompt + fed]), logits_at=list(range(P - 1, P + n)))[0]
        served = ref.argmax(-1)
        served[2] = ref[2].topk(2).indices[1]
        logits = ref[1:] + 0.01 * torch.randn(n, V, generator=g)
        samples.append({"prompt": prompt, "fed": fed, "served": served.tolist(), "logits": logits})
    return samples


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_are_drawn_as_before(name):
    conf = smoke_config(name)
    params = weights.make(arch.of(conf), conf["model"], 0, "cpu")
    assert leaf_hashes(params) == WEIGHTS[name]


@pytest.mark.parametrize("control", [False, True])
@pytest.mark.parametrize("name", CONFIGS)
def test_check_numbers_read_as_before(name, control):
    conf = smoke_config(name)
    mod, model = arch.of(conf), conf["model"]
    params = weights.make(mod, model, 0, "cpu")
    want = [{k: v for k, v in ref.items() if control or k == "program"} for ref in (KV[name], DECODE[name])]
    assert check.kv_numbers(mod, params, model, kv_sample(mod, params, model), 16, "cpu", control=control) == want[0]
    assert check.decode_numbers(mod, params, model, decode_sample(mod, params, model), "cpu",
                                control=control) == want[1]


@pytest.mark.parametrize("name", CELLS)
def test_operations_and_bytes_at_the_cells_shapes_as_before(name):
    cell = cellmod.resolve(name)
    mod, model = cell.arch, cell.config["model"]
    want = SHAPES[name]
    gen = cellmod.generator(cell.traffic["generator"], model["vocab_size"], 0)
    if cell.traffic["runner"] == "engine_loop":
        assert list(want["prefill_flops"]) == [gen.prompt_len]
    else:  # the decode steps attend over the prompt, its own token and those before
        assert list(want["decode_step"]) == [gen.prompt_len + 1, gen.prompt_len + gen.output_tokens]
    for fn in ("prefill_flops", "flash_call", "decode_step", "paged_decode_call"):
        for size, value in want.get(fn, {}).items():
            assert getattr(mod, fn)(model, size) == value, (fn, size)
    assert mod.block_bytes(model, engine_loop.BLOCK) == want["block_bytes"]

# (d) the checks a run of each cell prints, in order: a dense module has no
# routes, so no ``route_gap``
CHECKS = {
    "glm4-9b.docqa-hot": ["kv_fresh_err", "kv_promoted_err", "reuse_mismatches", "blocks_missing"],
    "glm4-9b.docqa-disk": ["kv_fresh_err", "kv_promoted_err", "reuse_mismatches", "blocks_missing"],
    "qwen3-14b.decode-long": ["decode_gap", "decode_logit_err"],
}


@pytest.mark.parametrize("name", CELLS)
def test_a_dense_cells_checks_are_as_before(name):
    cell = smoke_cell(name)
    assert cell.arch is dense_gqa and not getattr(dense_gqa, "ROUTED", False)
    out = kvrun.run_cell(cell, 2**31 + 21, 1.0, False, torch.device("cpu"))
    assert list(out["checks"]) == CHECKS[name]
    assert set(CHECKS[name]) == set(cellmod.resolve(name).limits)


class Built(Exception):
    pass


@pytest.mark.parametrize("name", CELLS)
def test_a_run_builds_the_kernels_it_built_before(name, monkeypatch):
    from repro_torch.kernels import _build

    built = []

    def build_all(names=None):
        built.append(names)
        raise Built

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(_build, "build_all", build_all)
    monkeypatch.setattr(sys, "path", list(sys.path))
    for k in kvrun.cache_dirs(ROOT):
        monkeypatch.setenv(k, os.environ.get(k, ""))
    with pytest.raises(Built):
        kvrun.main(["--workload", name, "--seed", "1", "--seconds", "1"])
    assert built == [["flash_attention", "decode_attention"]]
    assert cellmod.resolve(name).arch is dense_gqa


# A second architecture, provided by the test alone: a latent cache whose
# layers store two parts of different widths, as MLA's c_kv and k_rope.
TOY = "toy_latent"
TOY_MODEL = {"n_layers": 3, "d_model": 32, "latent": 12, "rope_dim": 4, "vocab_size": 64}


def toy_shapes(model):
    L, D, R, Dr, V = (model[k] for k in ("n_layers", "d_model", "latent", "rope_dim", "vocab_size"))
    return {"embed": (V, D), "blocks": {"norm": (L, D), "w_dkv": (L, D, R), "w_kr": (L, D, Dr), "w_up": (L, R, D)},
            "lm_head": (D, V)}


def toy_init(name, shape):
    return ("fill", 1.0) if name == "norm" else ("normal", shape[-2] ** -0.5)


def toy_forward(params, model, tokens, *, logits_at=None, precision="f32", on_state=None):
    p = {k: v.float() for k, v in params["blocks"].items()}
    x = params["embed"][tokens].float()
    for i in range(model["n_layers"]):
        h = x * p["norm"][i]
        # rounded to the stored type, so that blocks made from it read back exactly
        c, kr = (h @ p["w_dkv"][i]).half().float(), (h @ p["w_kr"][i]).half().float()
        if on_state is not None:
            on_state(i, {"c_kv": c, "k_rope": kr})
        x = x + torch.tanh(c) @ p["w_up"][i]
    return None if logits_at is None else x[:, list(logits_at)] @ params["lm_head"].float()


def toy_width(model):
    return model["n_layers"] * (model["latent"] + model["rope_dim"])


def toy_unpack(blocks, model, device):
    """A block is (block, L·(R + Dr)) float16: each token's row holds every
    layer's c_kv then k_rope, layer after layer."""
    if any(b is None or b.ndim != 2 or b.shape[1] != toy_width(model) for b in blocks):
        return None
    L, R = model["n_layers"], model["latent"]
    rows = torch.cat([torch.from_numpy(b) for b in blocks]) if blocks else torch.empty(0, toy_width(model))
    x = rows.to(device, torch.float32).reshape(-1, L, R + model["rope_dim"]).transpose(0, 1)
    return {"c_kv": x[..., :R], "k_rope": x[..., R:]}


def toy_pack(states, block):
    """{part: (L, S, width)} -> the stored blocks."""
    x = torch.cat([states["c_kv"], states["k_rope"]], dim=-1).transpose(0, 1)  # (S, L, R + Dr)
    rows = x.reshape(x.shape[0], -1).half().numpy()
    return [rows[i:i + block] for i in range(0, len(rows), block)]


def toy_module():
    mod = types.ModuleType(f"kvbench.arch.{TOY}")
    mod.check_config = lambda cfg, config: None
    mod.shapes, mod.init, mod.forward, mod.unpack_blocks = toy_shapes, toy_init, toy_forward, toy_unpack
    mod.block_bytes = lambda model, block: block * toy_width(model) * 2
    mod.prefill_flops = lambda model, S: 2.0 * S * toy_width(model) * model["d_model"]
    mod.flash_call = mod.decode_step = mod.paged_decode_call = lambda model, n: (1.0, 1.0)
    mod.KERNELS, mod.TEST_SIZES = [], {}
    return mod


def test_a_second_architecture_arrives_as_new_files_only(tmp_path, monkeypatch):
    mod = toy_module()
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    conf = {"name": "toy", "arch": TOY, "port_config": "glm4-9b", "smoke": True, "model": TOY_MODEL}
    path = tmp_path / "toy.json"
    path.write_text(json.dumps(conf))
    bench = {**BENCH, "configs": [{"name": "toy", "file": str(path)}],
             "workloads": [{"name": "toy.docqa-hot", "config": "toy", "traffic": "docqa-hot", "chips": 1}]}
    cell = cellmod.resolve("toy.docqa-hot", bench)
    assert cell.arch is mod and not (HERE / "arch" / f"{TOY}.py").exists()
    ctx = kvrun.Context(cell, 0, 1.0, False, torch.device("cpu"), False)
    assert ctx.arch is mod and ctx.model == TOY_MODEL

    params = weights.make(ctx.arch, ctx.model, 2**31 + 5, "cpu")
    assert params["blocks"]["w_kr"].shape == (3, 32, 4) and params["lm_head"].dtype == torch.bfloat16
    assert torch.equal(params["blocks"]["norm"], torch.ones(3, 32, dtype=torch.bfloat16))
    assert weights.count(mod, TOY_MODEL) == sum(t.numel() for t in
                                                 [params["embed"], params["lm_head"], *params["blocks"].values()])

    block, S = 16, 48
    tokens = torch.randint(0, 64, (2, S), generator=torch.Generator().manual_seed(1))
    layers = []
    toy_forward(params, TOY_MODEL, tokens, on_state=lambda i, p: layers.append(p))
    samples = []
    for b, reused in enumerate((16, 32)):
        stored = toy_pack({k: torch.stack([p[k][b] for p in layers]) for k in ("c_kv", "k_rope")}, block)
        samples.append({"tokens": tokens[b].tolist(), "reused": reused, "fresh": stored[reused // block:],
                        "promoted": stored[: reused // block]})
    got = check.kv_numbers(mod, params, TOY_MODEL, samples, block, "cpu")
    assert got == {"program": {"kv_fresh_err": 0.0, "kv_promoted_err": 0.0}}

    # one element of one part changed, in a fresh block and in a promoted one
    fresh = samples[0]["fresh"][1].copy()
    fresh[5, toy_width(TOY_MODEL) - 1] += 1.0  # the last layer's k_rope
    promoted = samples[1]["promoted"][0].copy()
    promoted[3, 2] += 1.0  # the first layer's c_kv
    samples[0]["fresh"][1], samples[1]["promoted"][0] = fresh, promoted
    got = check.kv_numbers(mod, params, TOY_MODEL, samples, block, "cpu")["program"]
    assert got["kv_fresh_err"] > 0 and got["kv_promoted_err"] > 0
