"""A routed model held against the reference under its own expert choices.

The architecture module is provided by the test alone (``toy_routed``,
registered under ``kvbench.arch``): Moonlight-16B-A3B's layout at toy
width, a dense SwiGLU layer, then MoE layers of 64 experts top-6 behind a
sigmoid router with a correction bias and a shared expert, each layer
storing a latent read through an RMSNorm and a rope key.  Its "program" is
its own forward with every product in bf16, handed over by a fake prefill
hook with the blocks and a ``route``, as the engine_loop runner takes them.
The control is its forward in fp8, as ``reference.py`` makes it."""

import gc
import math
import sys
import types
import weakref

import pytest
import torch

from kvbench import arch, check, reference, weights
from kvbench.cell import ROOT, load_json
from kvbench.tests.smoke import smoke_cell

TOY = "toy_routed"
MODEL = {"n_layers": 12, "n_dense": 1, "d_model": 128, "latent": 32, "rope_dim": 8, "n_experts": 64, "top_k": 6,
         "d_expert": 48, "d_shared": 96, "d_ff": 256, "vocab_size": 512, "router_scale": 2.446,
         "rms_norm_eps": 1e-5}
BLOCK, S = 16, 96
REUSED = (32, 64)
NORMS = ("attn_norm", "mlp_norm", "kv_norm", "final_norm")
F32 = torch.float32


def toy_shapes(m):
    L, D, R, Dr, V = (m[k] for k in ("n_layers", "d_model", "latent", "rope_dim", "vocab_size"))
    M, E, F, Fs, Fd = L - m["n_dense"], m["n_experts"], m["d_expert"], m["d_shared"], m["d_ff"]
    return {
        "embed": (V, D),
        "blocks": {"attn_norm": (L, D), "mlp_norm": (L, D), "kv_norm": (L, R), "w_dkv": (L, D, R),
                   "w_kr": (L, D, Dr), "w_q": (L, D, R + Dr), "w_o": (L, R, D)},
        "dense": {"w_gate": (m["n_dense"], D, Fd), "w_up": (m["n_dense"], D, Fd), "w_down": (m["n_dense"], Fd, D)},
        "moe": {"router": (M, D, E), "router_bias": (M, E), "w_gate": (M, E, D, F), "w_up": (M, E, D, F),
                "w_down": (M, E, F, D), "s_gate": (M, D, Fs), "s_up": (M, D, Fs), "s_down": (M, Fs, D)},
        "final_norm": (D,),
        "lm_head": (D, V),
    }


def toy_init(name, shape):
    if name in NORMS:
        return "fill", 1.0
    if name == "router_bias":
        return "normal", 0.01
    return "normal", shape[-2] ** -0.5


def linear(x, w, precision):
    """``reference.linear``, and the program's bf16: operands and product
    rounded to bf16, the product taken in f32."""
    if precision != "bf16":
        return reference.linear(x, w, precision)
    return (x.to(torch.bfloat16).to(F32) @ w.to(torch.bfloat16).to(F32)).to(torch.bfloat16).to(F32)


def swiglu(x, g, u, d, precision):
    return linear(torch.nn.functional.silu(linear(x, g, precision)) * linear(x, u, precision), d, precision)


def toy_forward(params, model, tokens, *, logits_at=None, precision="f32", on_state=None, route=None,
                on_route=None):
    eps, k, nd = model["rms_norm_eps"], model["top_k"], model["n_dense"]
    R = model["latent"]
    B, T = tokens.shape
    causal = torch.ones(T, T, dtype=torch.bool).tril()
    with torch.inference_mode():
        x = params["embed"][tokens].to(F32)
        for i in range(model["n_layers"]):
            p = {n: t[i].to(F32) for n, t in params["blocks"].items()}
            h = reference.rms_norm(x, p["attn_norm"], eps)
            # the stored state, rounded to its stored type so that blocks made
            # from the reference read back exactly
            c = reference.rms_norm(linear(h, p["w_dkv"], precision), p["kv_norm"], eps).half().to(F32)
            kr = linear(h, p["w_kr"], precision).half().to(F32)
            if on_state is not None:
                on_state(i, {"c_kv": c, "k_rope": kr})
            q = linear(h, p["w_q"], precision)
            sc = (q @ torch.cat([c, kr], -1).transpose(1, 2)) * (R + model["rope_dim"]) ** -0.5
            a = torch.softmax(sc.masked_fill(~causal, -math.inf), -1) @ c
            x = x + linear(a, p["w_o"], precision)
            h = reference.rms_norm(x, p["mlp_norm"], eps)
            if i < nd:
                d = {n: t[i].to(F32) for n, t in params["dense"].items()}
                x = x + swiglu(h, d["w_gate"], d["w_up"], d["w_down"], precision)
                continue
            e = {n: t[i - nd] for n, t in params["moe"].items()}
            scores = torch.sigmoid(linear(h, e["router"], precision))
            select = scores + e["router_bias"].to(F32)
            ids = arch.chosen(select, k, route, i)
            if on_route is not None:
                on_route(i, ids, select)
            gate = scores.gather(-1, ids)
            gate = gate / gate.sum(-1, keepdim=True) * model["router_scale"]
            hf, y = h.reshape(B * T, -1), torch.zeros(B * T, h.shape[-1])
            flat, wflat = ids.reshape(B * T, k), gate.reshape(B * T, k)
            for j in range(model["n_experts"]):
                rows, slot = (flat == j).nonzero(as_tuple=True)
                if rows.numel():
                    out = swiglu(hf[rows], e["w_gate"][j].to(F32), e["w_up"][j].to(F32), e["w_down"][j].to(F32),
                                 precision)
                    y.index_add_(0, rows, out * wflat[rows, slot, None])
            shared = swiglu(h, e["s_gate"].to(F32), e["s_up"].to(F32), e["s_down"].to(F32), precision)
            x = x + y.reshape(B, T, -1) + shared
        if logits_at is None:
            return None
        xs = reference.rms_norm(x[:, list(logits_at)], params["final_norm"].to(F32), eps)
        return linear(xs, params["lm_head"], precision)


def toy_width(model):
    return model["n_layers"] * (model["latent"] + model["rope_dim"])


def toy_unpack(blocks, model, device):
    """A block is (block, L·(R + Dr)) float16: each token's row holds every
    layer's c_kv then k_rope, layer after layer."""
    if any(b is None or b.ndim != 2 or b.shape[1] != toy_width(model) for b in blocks):
        return None
    L, R = model["n_layers"], model["latent"]
    rows = torch.cat([torch.as_tensor(b) for b in blocks]) if blocks else torch.empty(0, toy_width(model))
    x = rows.to(device, F32).reshape(-1, L, R + model["rope_dim"]).transpose(0, 1)
    return {"c_kv": x[..., :R], "k_rope": x[..., R:]}


def toy_module():
    mod = types.ModuleType(f"kvbench.arch.{TOY}")
    mod.ROUTED = True
    mod.check_config = lambda cfg, config: None
    mod.shapes, mod.init, mod.forward, mod.unpack_blocks = toy_shapes, toy_init, toy_forward, toy_unpack
    mod.block_bytes = lambda model, block: block * toy_width(model) * 2
    mod.KERNELS, mod.TEST_SIZES = [], {}
    return mod


@pytest.fixture(scope="module")
def toy():
    """The module, registered; the weights; two prompts."""
    mod = toy_module()
    old = sys.modules.get(mod.__name__)
    sys.modules[mod.__name__] = mod
    try:
        assert arch.of({"arch": TOY}) is mod
        params = weights.make(mod, MODEL, 2**31 + 9, "cpu")
        tokens = torch.randint(0, MODEL["vocab_size"], (len(REUSED), S), generator=torch.Generator().manual_seed(4))
        yield mod, params, tokens
    finally:
        if old is None:
            sys.modules.pop(mod.__name__)
        else:
            sys.modules[mod.__name__] = old


def stored(mod, params, tokens, precision):
    """One forward over ``tokens`` (B, S): each prompt's state as the stored
    blocks, and the experts each MoE layer took, {layer: (S, k)}."""
    states, route = [], {}
    mod.forward(params, MODEL, tokens, precision=precision, on_state=lambda i, parts: states.append(parts),
                on_route=lambda i, ids, scores: route.__setitem__(i, ids.clone()))
    x = torch.cat([torch.stack([p["c_kv"] for p in states]), torch.stack([p["k_rope"] for p in states])], -1)
    out = []
    for b in range(tokens.shape[0]):
        rows = x[:, b].transpose(0, 1).reshape(tokens.shape[1], -1).half().numpy()  # (S, L·(R + Dr))
        out.append(([rows[j:j + BLOCK] for j in range(0, len(rows), BLOCK)], {i: r[b] for i, r in route.items()}))
    return out


def fake_hook(mod, params, precision="bf16", with_route=True):
    """The program's prefill hook: the toy's forward in ``precision`` over the
    whole prompt, the fresh blocks handed back, and ``route`` set to the
    experts each MoE layer took where ``with_route``."""

    def hook(tokens, reused):
        [(blocks, route)] = stored(mod, params, torch.tensor([tokens]), precision)
        if with_route:
            hook.route = route
        return blocks[reused // BLOCK:], 0.0

    return hook


def program_samples(mod, params, tokens, **kw):
    """Each prompt's sample as the runner takes it: the cache's blocks of the
    reused prefix (made by an earlier request over the same prefix), the
    hook's fresh blocks and, where the hook has one, its route."""
    hook = fake_hook(mod, params, **kw)
    out = []
    for b, reused in enumerate(REUSED):
        toks = tokens[b].tolist()
        promoted = hook(toks, 0)[0][: reused // BLOCK]
        s = {"tokens": toks, "reused": reused, "fresh": hook(toks, reused)[0], "promoted": promoted}
        route = getattr(hook, "route", None)
        if route is not None:
            s["route"] = route
        out.append(s)
    return out


def numbers(mod, params, samples, control=False):
    return check.kv_numbers(mod, params, MODEL, samples, BLOCK, "cpu", control=control)


@pytest.fixture(scope="module")
def program(toy):
    """The bf16 program's samples and their numbers with the control."""
    mod, params, tokens = toy
    samples = program_samples(mod, params, tokens)
    return samples, numbers(mod, params, samples, control=True)


def test_routing_itself_the_reference_reads_the_program_as_high_as_the_control(toy):
    """(a) With the reference routing itself (the module read as not routed),
    near ties send tokens to other experts than the program's, and the bf16
    program reads at or above half the fp8 control: no limit separates them."""
    mod, params, tokens = toy
    unrouted = types.ModuleType(mod.__name__)
    unrouted.__dict__.update(vars(mod), ROUTED=False)
    samples = program_samples(unrouted, params, tokens, with_route=False)
    got = numbers(unrouted, params, samples, control=True)
    assert set(got["program"]) == set(check.KV)
    for name in check.KV:
        assert got["program"][name] >= 0.5 * got["control"][name], got


def test_under_its_own_routes_the_program_reads_far_below_the_control(program):
    """(b) Each side against the reference run under its own routes: the bf16
    program's every number below a third of the control's."""
    got = program[1]
    assert set(got["program"]) == set(got["control"]) == set(check.ROUTED_KV)
    for name in got["program"]:
        assert got["program"][name] < got["control"][name] / 3, got


def test_an_expert_swapped_against_a_clear_margin_reads_above_the_control(toy, program):
    """(c) One token at one MoE layer takes its worst-scored expert in place
    of its best: ``route_gap`` reads above the control's."""
    mod, params, tokens = toy
    samples, got = program
    layer, b, t = MODEL["n_dense"] + 3, 1, S - 5
    scores = {}
    mod.forward(params, MODEL, tokens, route=check._routes(samples, "cpu"),
                on_route=lambda i, ids, sel: scores.__setitem__(i, sel))
    swapped = [dict(s, route=dict(s["route"])) for s in samples]
    ids = swapped[b]["route"][layer].clone()
    ids[t, 0] = int(scores[layer][b, t].argmin())
    swapped[b]["route"][layer] = ids
    bad = numbers(mod, params, swapped)["program"]
    assert bad["route_gap"] > got["control"]["route_gap"], (bad, got)


@pytest.mark.parametrize("fault", ["no_route", "layer_missing", "id_out_of_range", "id_repeated"])
def test_a_route_missing_or_refused_reads_inf(toy, program, fault):
    """(d) A hook without ``route`` reads ``inf`` in all three numbers, and so
    does a route that holds no valid choice for a layer."""
    mod, params, tokens = toy
    if fault == "no_route":
        samples = program_samples(mod, params, tokens, with_route=False)
    else:
        samples = [dict(s, route=dict(s["route"])) for s in program[0]]
        last = max(samples[0]["route"])
        if fault == "layer_missing":
            for s in samples:
                del s["route"][last]
        else:
            ids = samples[0]["route"][last].clone()
            ids[7, 2] = MODEL["n_experts"] if fault == "id_out_of_range" else ids[7, 1]
            samples[0]["route"][last] = ids
    got = numbers(mod, params, samples)
    assert got == {"program": dict.fromkeys(check.ROUTED_KV, math.inf)}


def test_blocks_and_routes_from_the_reference_itself_read_0(toy):
    """(e) The reference's own f32 states as the blocks and its own choices as
    the route read 0 in all three numbers."""
    mod, params, tokens = toy
    samples = [{"tokens": tokens[b].tolist(), "reused": r, "fresh": blocks[r // BLOCK:],
                "promoted": blocks[: r // BLOCK], "route": route}
               for b, (r, (blocks, route)) in enumerate(zip(REUSED, stored(mod, params, tokens, "f32")))]
    assert numbers(mod, params, samples) == {"program": dict.fromkeys(check.ROUTED_KV, 0.0)}


def test_route_gap():
    scores = torch.tensor([[0.9, 0.5, 0.7, 0.1], [0.2, 0.4, 0.3, 0.8]])
    std = scores.std(-1)
    assert check.route_gap(torch.tensor([[0, 2], [3, 1]]), scores) == 0.0  # each token's top 2
    got = check.route_gap(torch.tensor([[0, 1], [3, 1]]), scores)  # token 0 takes 0.5 over 0.7
    assert got == pytest.approx(float(0.2 / std[0]))


class Ids(torch.Tensor):
    """A route's ids, whose clones the test can count."""

    clones: list = []

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        out = super().__torch_function__(func, types, args, kwargs or {})
        if func is torch.Tensor.clone:
            cls.clones.append(weakref.ref(out))
        return out

    @classmethod
    def alive(cls):
        gc.collect()
        return sum(r() is not None for r in cls.clones)


ENGINE = [w["name"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]
          if load_json(ROOT / "kvbench" / "traffic" / f"{w['traffic']}.json")["runner"] == "engine_loop"]
SAMPLE_KEYS = {"tokens", "reused", "fresh", "promoted"}
WINDOW_KEYS = {"window_s", "requests", "late", "cache", "commit", "wchar", "block_bytes", "fetch_s",
                     "profile", "memory_peak_bytes", "numbers", "control", "prefill_flops", "flash_call",
                     "sampled", "check_s"}


@pytest.mark.parametrize("with_route", [True, False])
def test_the_runner_keeps_only_the_sampled_requests_routes(monkeypatch, with_route):
    """The engine_loop runner on the CPU (glm4-9b's smoke cell) with a hook
    that has a ``route`` and one without: with it, once the window has
    closed only the sampled requests' clones are alive, each its own
    request's, on the host; without it, the samples and the window are
    as before."""
    from kvbench import run as kvrun
    from kvbench.runners import engine_loop
    from repro_torch.serving import real_prefill

    make = real_prefill.make_real_prefill
    L = smoke_cell(ENGINE[0]).config["model"]["n_layers"]

    def make_with_route(*args, **kwargs):
        inner = make(*args, **kwargs)

        def hook(tokens, reused):
            out = inner(tokens, reused)
            # ids that tell the request apart: its question's last tokens
            ids = torch.as_tensor(tokens[-6:])[None, :].repeat(len(tokens), 1).as_subclass(Ids)
            hook.route = {i: ids + i for i in range(1, L)}
            return out

        return hook

    Ids.clones.clear()
    if with_route:
        monkeypatch.setattr(real_prefill, "make_real_prefill", make_with_route)
    seen = {}
    kv_numbers = check.kv_numbers

    def spy(arch_, params, model, samples, *args, **kwargs):
        seen.update(samples=samples, alive=Ids.alive())
        return kv_numbers(arch_, params, model, samples, *args, **kwargs)

    monkeypatch.setattr(check, "kv_numbers", spy)
    run = engine_loop.run(kvrun.Context(smoke_cell(ENGINE[0]), 2**31 + 11, 1.0, False, torch.device("cpu"), False))
    samples = seen["samples"]
    assert len(samples) == engine_loop.SAMPLE < len(run["requests"])
    assert set(run) == WINDOW_KEYS
    assert set(run["numbers"]) == {*check.KV, "reuse_mismatches", "blocks_missing"}
    if not with_route:
        assert all(set(s) == SAMPLE_KEYS for s in samples) and seen["alive"] == 0
        return
    assert seen["alive"] == len(samples) * (L - 1)
    for s in samples:
        assert set(s) == SAMPLE_KEYS | {"route"} and set(s["route"]) == set(range(1, L))
        for i, ids in s["route"].items():
            assert ids.device.type == "cpu" and ids.shape == (len(s["tokens"]), 6)
            assert torch.equal(ids, torch.as_tensor(s["tokens"][-6:])[None, :].expand_as(ids) + i)
