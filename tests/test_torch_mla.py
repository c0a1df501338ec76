"""The port's Multi-head Latent Attention (``repro_torch.models.layers``
``mla_project_latent``, ``mla_queries``, ``mla_attention`` and the mla
branch of ``lm_forward``) against the reference at smoke size: the
training form, prefill at pos 0, chained prefill at pos > 0 and the
absorbed decode, each also with a v head dim that differs from the q/k
head dim (the smoke config has qk 16 = v 16; minicpm3-4b has 96 and 64),
and minicpm3-smoke prefill and decode.  On the CPU the flash wrapper runs
its plain version."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from parity_harness import MODEL_TOL, jax_params_to_torch, np32, torch_from

from repro.configs import get_config
from repro.models import api as jax_api
from repro.models import layers as jax_layers
from repro.models.common import tree_init as jax_tree_init
from repro_torch.models import api, layers, transformer

# Tolerances, each with its reason.
# f32 end to end: the same f32 arithmetic, sums (the flash plain version's
# einsum against the reference's direct softmax, the absorbed einsums) in
# another order.
MLA_F32_TOL = 1e-4
# smoke models on f32 parameters and caches: two layers, sums in another order
F32_MODEL_TOL = 1e-4

SMOKE = get_config("minicpm3-4b", smoke=True)
CFGS = {"dv16": SMOKE, "dv8": dataclasses.replace(SMOKE, v_head_dim=8)}
B, S, S_MAX = 2, 10, 16


def _params(cfg, seed=0):
    p = jax_tree_init(jax_layers.build_mla_template(cfg), jax.random.key(seed))
    p = jax.tree.map(lambda a: a.astype(jnp.float32), p)
    return p, jax_params_to_torch(p, "cpu")


def _x(seed, S_, cfg):
    return np.random.default_rng(seed).standard_normal((B, S_, cfg.d_model)).astype(np.float32)


def _positions(pos, S_):
    p = pos + np.arange(S_, dtype=np.int32)[None, :].repeat(B, 0)
    return jnp.asarray(p), torch.from_numpy(p)


def _close(got, want, tol=MLA_F32_TOL):
    np.testing.assert_allclose(np32(got), np32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", list(CFGS))
def test_mla_latent_and_queries_match_reference(name):
    cfg = CFGS[name]
    jp, tp = _params(cfg, 1)
    x = _x(1, S, cfg)
    jpos, tpos = _positions(3, S)
    jc, jkr = jax_layers.mla_project_latent(jp, cfg, jnp.asarray(x), jpos)
    tc, tkr = layers.mla_project_latent(tp, cfg, torch_from(x), tpos)
    assert tc.shape == (B, S, cfg.kv_lora_rank) and tkr.shape == (B, S, cfg.qk_rope_dim)
    _close(tc, jc)
    _close(tkr, jkr)
    jqn, jqr = jax_layers.mla_queries(jp, cfg, jnp.asarray(x), jpos)
    tqn, tqr = layers.mla_queries(tp, cfg, torch_from(x), tpos)
    assert tqn.shape == (B, S, cfg.n_heads, cfg.qk_nope_dim) and tqr.shape == (B, S, cfg.n_heads, cfg.qk_rope_dim)
    _close(tqn, jqn)
    _close(tqr, jqr)


@pytest.mark.parametrize("name", list(CFGS))
def test_mla_attention_training_form_matches_reference(name):
    cfg = CFGS[name]
    jp, tp = _params(cfg, 2)
    x = _x(2, S, cfg)
    jpos, tpos = _positions(0, S)
    want, jcache = jax_layers.mla_attention(jp, cfg, jnp.asarray(x), jpos, None)
    got, tcache = layers.mla_attention(tp, cfg, torch_from(x), tpos, None)
    assert jcache is None and tcache is None and got.shape == (B, S, cfg.d_model)
    _close(got, want)


def _caches(cfg):
    jc = (jnp.zeros((B, S_MAX, cfg.kv_lora_rank), jnp.float32), jnp.zeros((B, S_MAX, cfg.qk_rope_dim), jnp.float32))
    tc = (torch.zeros(B, S_MAX, cfg.kv_lora_rank), torch.zeros(B, S_MAX, cfg.qk_rope_dim))
    return jc, tc


@pytest.mark.parametrize("name", list(CFGS))
def test_mla_attention_prefill_at_pos_zero_matches_reference(name):
    cfg = CFGS[name]
    jp, tp = _params(cfg, 3)
    x = _x(3, S, cfg)
    jpos, tpos = _positions(0, S)
    (jc, jkr), (tc, tkr) = _caches(cfg)
    want, (jc, jkr) = jax_layers.mla_attention(jp, cfg, jnp.asarray(x), jpos, (jc, jkr, 0))
    got, (tc2, tkr2) = layers.mla_attention(tp, cfg, torch_from(x), tpos, (tc, tkr, 0), q_offset=0)
    assert tc2 is tc and tkr2 is tkr  # the cache is written in place
    _close(got, want)
    _close(tc, jc)
    _close(tkr, jkr)
    assert not tc[:, S:].any()


@pytest.mark.parametrize("name", list(CFGS))
def test_mla_attention_chained_prefill_matches_reference(name):
    """A prefix of 6 tokens, then 4 more at pos 6 over the cached latent."""
    cfg = CFGS[name]
    jp, tp = _params(cfg, 4)
    x = _x(4, S, cfg)
    (jc, jkr), (tc, tkr) = _caches(cfg)
    jpos, tpos = _positions(0, 6)
    _, (jc, jkr) = jax_layers.mla_attention(jp, cfg, jnp.asarray(x[:, :6]), jpos, (jc, jkr, 0))
    layers.mla_attention(tp, cfg, torch_from(x[:, :6]), tpos, (tc, tkr, 0), q_offset=0)
    jpos, tpos = _positions(6, 4)
    want, (jc, jkr) = jax_layers.mla_attention(jp, cfg, jnp.asarray(x[:, 6:]), jpos, (jc, jkr, 6))
    got, _ = layers.mla_attention(tp, cfg, torch_from(x[:, 6:]), tpos, (tc, tkr, 6), q_offset=6)
    _close(got, want)
    _close(tc, jc)
    # the chained output equals the tail of a single-shot prefill
    (_, _), (tc1, tkr1) = _caches(cfg)
    jpos, tpos = _positions(0, S)
    full, _ = layers.mla_attention(tp, cfg, torch_from(x), tpos, (tc1, tkr1, 0), q_offset=0)
    _close(got, full[:, 6:])


@pytest.mark.parametrize("name", list(CFGS))
def test_mla_absorbed_decode_matches_reference(name):
    """Prefill 7 tokens, then decode 3 one at a time through the absorbed
    path; each step also equals the materialised form over the same cache."""
    cfg = CFGS[name]
    jp, tp = _params(cfg, 5)
    x = _x(5, S, cfg)
    (jc, jkr), (tc, tkr) = _caches(cfg)
    jpos, tpos = _positions(0, 7)
    _, (jc, jkr) = jax_layers.mla_attention(jp, cfg, jnp.asarray(x[:, :7]), jpos, (jc, jkr, 0))
    layers.mla_attention(tp, cfg, torch_from(x[:, :7]), tpos, (tc, tkr, 0), q_offset=0)
    for t in range(7, S):
        jpos, tpos = _positions(t, 1)
        want, (jc, jkr) = jax_layers.mla_attention(jp, cfg, jnp.asarray(x[:, t:t + 1]), jpos, (jc, jkr, t))
        got, _ = layers.mla_attention(tp, cfg, torch_from(x[:, t:t + 1]), tpos, (tc, tkr, t), q_offset=t)
        _close(got, want)
        _close(tc, jc)
        _close(tkr, jkr)
    # absorbed == materialised: the training form over all S tokens, last row
    tpos = torch.from_numpy(np.arange(S, dtype=np.int32)[None, :].repeat(B, 0))
    full, _ = layers.mla_attention(tp, cfg, torch_from(x), tpos, None)
    _close(got, full[:, -1:])


def test_mla_decode_launches_nothing_and_prefill_uses_flash_shapes():
    """The absorbed decode is plain torch; prefill hands flash q/k of head
    dim dn+dr and v of head dim dv (Dv != Dqk)."""
    cfg = CFGS["dv8"]
    _, tp = _params(cfg, 6)
    seen = []
    real = layers.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[-1], k.shape[-1], v.shape[-1]))
        return real(q, k, v, **kw)

    layers.flash_attention = spy
    try:
        (_, _), (tc, tkr) = _caches(cfg)
        x = torch_from(_x(6, 5, cfg))
        tpos = torch.arange(5, dtype=torch.int32)[None].repeat(B, 1)
        layers.mla_attention(tp, cfg, x[:, :4], tpos[:, :4], (tc, tkr, 0))
        layers.mla_attention(tp, cfg, x[:, 4:], tpos[:, 4:], (tc, tkr, 4))
    finally:
        layers.flash_attention = real
    dqk = cfg.qk_nope_dim + cfg.qk_rope_dim
    assert seen == [(dqk, dqk, 8)]


# --------------------------------------------------------- minicpm3 model
def _setup(seed, f32):
    jparams = jax_api.init_params(SMOKE, jax.random.key(seed))
    if f32:
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    toks = np.random.default_rng(seed).integers(0, SMOKE.vocab_size, (B, 12)).astype(np.int32)
    return jparams, jax_params_to_torch(jparams, "cpu"), toks


@pytest.mark.parametrize("f32", [False, True])
def test_minicpm3_prefill_and_decode_match_reference(f32):
    """Prefill 6 tokens, then teacher-forced decode of 6: logits at every
    step and the latent cache c/kr.  bf16 at the harness's MODEL_TOL, f32
    at F32_MODEL_TOL."""
    jparams, tparams, toks = _setup(7, f32)
    tol = F32_MODEL_TOL if f32 else MODEL_TOL
    S_, half = toks.shape[1], 6
    jc, tc = jax_api.init_cache(SMOKE, B, S_), api.init_cache(SMOKE, B, S_, "cpu")
    assert tc["c"].shape == (SMOKE.n_layers, B, 16, SMOKE.kv_lora_rank) and tc["c"].dtype == torch.bfloat16
    assert tc["kr"].shape == (SMOKE.n_layers, B, 16, SMOKE.qk_rope_dim) and tc["kr"].dtype == torch.bfloat16
    if f32:
        jc = jax.tree.map(lambda a: a.astype(jnp.float32), jc)
        tc = {k: v.float() for k, v in tc.items()}
    jl, jc = jax.jit(jax_api.prefill_fn(SMOKE))(jparams, {"tokens": jnp.asarray(toks[:, :half])}, jc, 0)
    tl, tc = api.prefill_fn(SMOKE)(tparams, {"tokens": torch.from_numpy(toks[:, :half]).long()}, tc, 0)
    np.testing.assert_allclose(np32(tl), np32(jl), rtol=tol, atol=tol)
    jdec = jax.jit(jax_api.decode_fn(SMOKE))
    for t in range(half, S_):
        jl, jc = jdec(jparams, jnp.asarray(toks[:, t:t + 1]), jc, t)
        tl, tc = api.decode_fn(SMOKE)(tparams, torch.from_numpy(toks[:, t:t + 1]).long(), tc, t)
        np.testing.assert_allclose(np32(tl), np32(jl), rtol=tol, atol=tol)
    for name in ("c", "kr"):
        np.testing.assert_allclose(np32(tc[name][:, :, :S_]), np32(jc[name]), rtol=tol, atol=tol)


def test_minicpm3_decode_matches_training_forward():
    """Prefill + absorbed decode through the latent cache reproduces the
    cache-free forward (tests/test_models.py:50's invariant), f32."""
    _, tparams, toks = _setup(8, True)
    t = torch.from_numpy(toks).long()
    ref, _, aux = transformer.lm_forward(tparams, SMOKE, t)
    assert float(aux["aux_loss"]) == 0.0
    cache = {k: v.float() for k, v in api.init_cache(SMOKE, B, t.shape[1], "cpu").items()}
    logits, cache = api.prefill_fn(SMOKE)(tparams, {"tokens": t[:, :5]}, cache, 0)
    got = [logits]
    for i in range(5, t.shape[1]):
        lg, cache = api.decode_fn(SMOKE)(tparams, t[:, i:i + 1], cache, i)
        got.append(lg)
    np.testing.assert_allclose(np32(torch.cat(got, dim=1)), np32(ref), rtol=F32_MODEL_TOL, atol=F32_MODEL_TOL)
