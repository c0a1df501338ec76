"""The port's MoE (``repro_torch.models.layers.moe_layer``, ``moe_aux_loss``
and the moe family of ``lm_forward``) against the reference at smoke size:
the layer in f32, dropping and dropless, the dense per-token oracle and the
capacity drop of tests/test_models.py:146,178, the Switch aux loss, and
olmoe-smoke / kimi-smoke prefill, decode and training-forward aux loss
(in f32: in bf16 a near-tie routing choice may flip between the packages).
Inputs are made with numpy from a seed; parameters are the reference's,
converted through ``repro_torch.models.convert``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from parity_harness import BF16_TOL, jax_params_to_torch, np32, torch_from

from repro.configs import get_config
from repro.models import api as jax_api
from repro.models import layers as jax_layers
from repro.models import transformer as jax_transformer
from repro.models.common import tree_init as jax_tree_init
from repro_torch.models import api, layers, transformer

# Tolerances, each with its reason.
# f32 end to end: the same routing and the same f32 products with sums in
# another order; the reference's own MoE oracle test holds 1e-4
# (tests/test_models.py:175).
MOE_F32_TOL = 1e-4
# smoke models on f32 parameters and caches: two layers of the same f32
# arithmetic, sums in another order
F32_MODEL_TOL = 1e-4

MOE_ARCHS = ["olmoe-1b-7b", "kimi-k2-1t-a32b"]
B, S = 2, 12


def _moe_params(cfg, seed=0):
    """The reference's MoE parameters in f32: (JAX tree, torch tree)."""
    p = jax_tree_init(jax_layers.build_moe_template(cfg), jax.random.key(seed))
    p = jax.tree.map(lambda a: a.astype(jnp.float32), p)
    return p, jax_params_to_torch(p, "cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("Bx,Sx,capacity_factor,dropless", [
    (2, 16, None, False),    # the config's own capacity factor: some overflow drops
    (2, 16, 0.25, False),    # capacity 0.25: most routed pairs drop
    (3, 9, None, True),      # dropless, C = S·k
    (1, 2080, None, True),   # dropless with S·k > 4096: C from max(2, cf)
])
def test_moe_layer_matches_reference_f32(arch, Bx, Sx, capacity_factor, dropless):
    cfg = get_config(arch, smoke=True)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    jp, tp = _moe_params(cfg, seed=Sx)
    x = np.random.default_rng(Bx * 100 + Sx).standard_normal((Bx, Sx, cfg.d_model))
    want, wprobs = jax_layers.moe_layer(jp, cfg, jnp.asarray(x, jnp.float32), dropless=dropless)
    got, probs = layers.moe_layer(tp, cfg, torch_from(x), dropless=dropless)
    assert got.shape == (Bx, Sx, cfg.d_model) and probs.shape == (Bx * Sx, cfg.n_experts)
    assert probs.dtype == torch.float32
    np.testing.assert_allclose(np32(probs), np32(wprobs), rtol=MOE_F32_TOL, atol=MOE_F32_TOL)
    np.testing.assert_allclose(np32(got), np32(want), rtol=MOE_F32_TOL, atol=MOE_F32_TOL)


@pytest.mark.parametrize("dropless", [False, True])
def test_moe_matches_dense_oracle(dropless):
    """With ample capacity, sort-based dispatch equals the per-token dense
    oracle (tests/test_models.py:146, same config and tolerance)."""
    cfg = dataclasses.replace(get_config("olmoe-1b-7b", smoke=True), capacity_factor=8.0,
                              n_experts=4, experts_per_token=2)
    jp, tp = _moe_params(cfg, seed=42)
    x = np.random.default_rng(2).standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    out, _ = layers.moe_layer(tp, cfg, torch_from(x), dropless=dropless)

    xf = x.reshape(-1, cfg.d_model)
    logits = xf @ np.asarray(jp["router"], np.float32)
    pr = np.exp(logits - logits.max(-1, keepdims=True))
    pr /= pr.sum(-1, keepdims=True)
    topk = np.argsort(-pr, axis=-1)[:, :cfg.experts_per_token]
    ref = np.zeros_like(xf)
    for t in range(xf.shape[0]):
        wsum = pr[t, topk[t]].sum()
        for e in topk[t]:
            wg, wu, wd = (np.asarray(jp[name][e]) for name in ("w_gate", "w_up", "w_down"))
            h = (xf[t] @ wg) * (1 / (1 + np.exp(-(xf[t] @ wg)))) * (xf[t] @ wu)
            ref[t] += (pr[t, e] / wsum) * (h @ wd)
    np.testing.assert_allclose(np32(out).reshape(-1, cfg.d_model), ref, rtol=1e-4, atol=1e-4)


def test_moe_drops_over_capacity_like_the_reference():
    """Identical tokens all route to one expert; capacity 16·1/4·0.25 = 1
    slot serves one token and drops the rest (tests/test_models.py:178)."""
    cfg = dataclasses.replace(get_config("olmoe-1b-7b", smoke=True), capacity_factor=0.25,
                              n_experts=4, experts_per_token=1)
    jp = jax_tree_init(jax_layers.build_moe_template(cfg), jax.random.key(0))
    # the reference runs its bf16 experts on f32 x, promoting to f32; torch
    # does not promote, so the port gets the same values as f32 leaves
    tp = jax_params_to_torch(jax.tree.map(lambda a: a.astype(jnp.float32), jp), "cpu")
    x = np.full((1, 16, cfg.d_model), 0.3, np.float32)
    got, _ = layers.moe_layer(tp, cfg, torch_from(x))
    want, _ = jax_layers.moe_layer(jp, cfg, jnp.asarray(x))
    nz = np.abs(np32(got)).sum(axis=-1) > 1e-6
    assert 1 <= nz.sum() <= 2
    np.testing.assert_array_equal(nz, np.abs(np32(want)).sum(axis=-1) > 1e-6)
    np.testing.assert_allclose(np32(got), np32(want), rtol=MOE_F32_TOL, atol=MOE_F32_TOL)


def test_moe_routing_keeps_the_lower_expert_first_among_ties():
    """``lax.top_k`` takes the lower index first among equal values; the
    port's stable descending sort does the same (a zero router makes every
    probability equal)."""
    cfg = get_config("olmoe-1b-7b", smoke=True)
    _, tp = _moe_params(cfg)
    tp["router"] = torch.zeros_like(tp["router"])
    x = torch_from(np.random.default_rng(0).standard_normal((1, 3, cfg.d_model)))
    _, _, gate_e = layers.moe_route(tp, cfg, x)
    _, want = jax.lax.top_k(jnp.full((1, 3, cfg.n_experts), 1.0 / cfg.n_experts), cfg.experts_per_token)
    np.testing.assert_array_equal(gate_e.numpy(), np.asarray(want))


@pytest.mark.parametrize("T,E,k", [(24, 4, 2), (64, 64, 8)])
def test_moe_aux_loss_matches_reference(T, E, k):
    rng = np.random.default_rng(T + E)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    gate_e = np.argsort(-probs, axis=-1)[:, :k]
    want = jax_layers.moe_aux_loss(jnp.asarray(probs), jnp.asarray(gate_e), E)
    got = layers.moe_aux_loss(torch.from_numpy(probs), torch.from_numpy(gate_e).long(), E)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ------------------------------------------------------------ moe models
def _setup(arch, seed, f32):
    cfg = get_config(arch, smoke=True)
    jparams = jax_api.init_params(cfg, jax.random.key(seed))
    if f32:
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return cfg, jparams, jax_params_to_torch(jparams, "cpu"), toks


def _caches(cfg, f32):
    jc, tc = jax_api.init_cache(cfg, B, S), api.init_cache(cfg, B, S, "cpu")
    if f32:
        jc = jax.tree.map(lambda a: a.astype(jnp.float32), jc)
        tc = {k: v.float() for k, v in tc.items()}
    return jc, tc


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_and_decode_match_reference(arch):
    """Prefill of half the tokens, then teacher-forced decode of the rest
    (dropless, as the reference runs MoE with a cache): logits at every
    step and the k/v cache, on f32 parameters and caches.  Routing decides
    the result here: in bf16 a one-ulp difference in the router's input
    flips a near-tie choice (a top-2 margin of 5.5e-5 in kimi-smoke's
    layer 1 at decode step 3, seed 1), so parity runs in f32, as the
    reference's own MoE test does (tests/test_models.py:146-175)."""
    cfg, jparams, tparams, toks = _setup(arch, seed=1, f32=True)
    tol = F32_MODEL_TOL
    half = S // 2
    jc, tc = _caches(cfg, f32=True)
    jl, jc = jax.jit(jax_api.prefill_fn(cfg))(jparams, {"tokens": jnp.asarray(toks[:, :half])}, jc, 0)
    tl, tc = api.prefill_fn(cfg)(tparams, {"tokens": torch.from_numpy(toks[:, :half]).long()}, tc, 0)
    np.testing.assert_allclose(np32(tl), np32(jl), rtol=tol, atol=tol)
    jdec = jax.jit(jax_api.decode_fn(cfg))
    for t in range(half, S):
        jl, jc = jdec(jparams, jnp.asarray(toks[:, t:t + 1]), jc, t)
        tl, tc = api.decode_fn(cfg)(tparams, torch.from_numpy(toks[:, t:t + 1]).long(), tc, t)
        np.testing.assert_allclose(np32(tl), np32(jl), rtol=tol, atol=tol)
    for name in ("k", "v"):
        np.testing.assert_allclose(np32(tc[name][:, :, :S]), np32(jc[name]), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_layer_matches_reference_bf16(arch):
    """bf16 activations and experts, the models' own dtypes, on identical
    inputs: the f32 router sees the same x, so routing agrees, and the
    expert products round to bf16 on both sides (harness BF16_TOL)."""
    cfg = get_config(arch, smoke=True)
    jp = jax_tree_init(jax_layers.build_moe_template(cfg), jax.random.key(3))
    tp = jax_params_to_torch(jp, "cpu")
    x = np.random.default_rng(3).standard_normal((2, 10, cfg.d_model))
    for dropless in (False, True):
        want, _ = jax_layers.moe_layer(jp, cfg, jnp.asarray(x, jnp.bfloat16), dropless=dropless)
        got, _ = layers.moe_layer(tp, cfg, torch_from(x, torch.bfloat16), dropless=dropless)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(np32(got), np32(want), rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_bf16_prefill_and_decode_keep_the_reference_dtypes(arch):
    """In bf16 the logits and the k/v cache stay bf16 and finite, and the
    cache has the reference's layout (rounded up to 16-slot pages)."""
    cfg, jparams, tparams, toks = _setup(arch, seed=4, f32=False)
    tc = api.init_cache(cfg, B, S, "cpu")
    jc = jax_api.init_cache(cfg, B, S)
    assert {k: (tuple(v.shape[:2]), tuple(v.shape[3:])) for k, v in tc.items()} == \
        {k: (tuple(v.shape[:2]), tuple(v.shape[3:])) for k, v in jc.items()}
    tl, tc = api.prefill_fn(cfg)(tparams, {"tokens": torch.from_numpy(toks[:, :8]).long()}, tc, 0)
    tl2, tc = api.decode_fn(cfg)(tparams, torch.from_numpy(toks[:, 8:9]).long(), tc, 8)
    for t in (tl, tl2, tc["k"], tc["v"]):
        assert t.dtype == torch.bfloat16 and bool(torch.isfinite(t.float()).all())
    assert tc["k"].shape[2] == 16 and not tc["k"][:, :, 9:].any()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_training_forward_and_aux_loss_match_reference(arch):
    """The cache-free forward (capacity-dropping dispatch) and its aux
    loss, the sum over layers of n_experts·Σ me², on f32 parameters."""
    cfg, jparams, tparams, toks = _setup(arch, seed=2, f32=True)
    jl, _, jaux = jax_transformer.lm_forward(jparams, cfg, jnp.asarray(toks))
    tl, cache, taux = transformer.lm_forward(tparams, cfg, torch.from_numpy(toks).long())
    assert cache is None and taux["aux_loss"].dtype == torch.float32
    np.testing.assert_allclose(np32(tl), np32(jl), rtol=F32_MODEL_TOL, atol=F32_MODEL_TOL)
    np.testing.assert_allclose(float(taux["aux_loss"]), float(jaux["aux_loss"]), rtol=1e-5)
    assert float(taux["aux_loss"]) >= cfg.n_layers  # E·Σ me² >= 1 per layer (Cauchy-Schwarz)


def test_moe_aux_loss_is_zero_for_a_dense_model():
    cfg = get_config("qwen3-14b", smoke=True)
    params = api.init_params(cfg, 0, "cpu")
    _, _, aux = transformer.lm_forward(params, cfg, torch.zeros(1, 4, dtype=torch.long))
    assert float(aux["aux_loss"]) == 0.0
