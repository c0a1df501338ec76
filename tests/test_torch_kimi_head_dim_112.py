"""kimi-k2 narrowed to two heads of its own head dim, 112, with all 384
experts (top-8), against the reference: prefill logits, the k/v cache and
two teacher-forced decode steps, on f32 parameters and caches, with the
reference's parameters carried across by ``repro_torch.models.convert``.
Every width the CPU can afford is kimi-k2's: head dim 112 (d_model 224
over 2 heads, 1 KV head: G 2), 384 experts, top-8, dropless under a cache;
moe_d_ff, the vocabulary and the depth are cut.  In f32 because in bf16 a
one-ulp difference in the router's input may flip a near-tie top-8 choice
(tests/test_torch_moe.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from parity_harness import jax_params_to_torch, np32

from repro.configs import get_config
from repro.models import api as jax_api
from repro_torch.models import api

# f32 end to end: the same routing and the same f32 products, sums taken in
# another order (tests/test_torch_moe.py's F32_MODEL_TOL)
F32_MODEL_TOL = 1e-4
B, S, PREFILL = 2, 10, 8


def _narrow_kimi():
    return dataclasses.replace(get_config("kimi-k2-1t-a32b"), name="kimi-k2-narrow", n_layers=2, d_model=224,
                               n_heads=2, n_kv_heads=1, d_head=112, d_ff=64, moe_d_ff=32, vocab_size=512)


def test_narrow_kimi_prefill_cache_and_decode_match_reference():
    cfg = _narrow_kimi()
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jax_api.init_params(cfg, jax.random.key(7)))
    tparams = jax_params_to_torch(jparams, "cpu")
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    full = get_config("kimi-k2-1t-a32b")
    assert cfg.d_head == full.d_head == full.d_model // full.n_heads == 112
    assert (cfg.n_experts, cfg.experts_per_token) == (full.n_experts, full.experts_per_token) == (384, 8)
    jc = jax.tree.map(lambda a: a.astype(jnp.float32), jax_api.init_cache(cfg, B, S))
    tc = {k: v.float() for k, v in api.init_cache(cfg, B, S, "cpu").items()}
    jl, jc = jax.jit(jax_api.prefill_fn(cfg))(jparams, {"tokens": jnp.asarray(toks[:, :PREFILL])}, jc, 0)
    tl, tc = api.prefill_fn(cfg)(tparams, {"tokens": torch.from_numpy(toks[:, :PREFILL]).long()}, tc, 0)
    assert tl.shape == (B, PREFILL, cfg.vocab_size)
    np.testing.assert_allclose(np32(tl), np32(jl), rtol=F32_MODEL_TOL, atol=F32_MODEL_TOL)
    for name in ("k", "v"):
        assert tc[name].shape[-1] == 112
        np.testing.assert_allclose(np32(tc[name][:, :, :S]), np32(jc[name]), rtol=F32_MODEL_TOL,
                                   atol=F32_MODEL_TOL)
    jdec = jax.jit(jax_api.decode_fn(cfg))
    for t in range(PREFILL, S):  # two decode steps
        jl, jc = jdec(jparams, jnp.asarray(toks[:, t:t + 1]), jc, t)
        tl, tc = api.decode_fn(cfg)(tparams, torch.from_numpy(toks[:, t:t + 1]).long(), tc, t)
        np.testing.assert_allclose(np32(tl), np32(jl), rtol=F32_MODEL_TOL, atol=F32_MODEL_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(np32(tc[name][:, :, :S]), np32(jc[name]), rtol=F32_MODEL_TOL,
                                   atol=F32_MODEL_TOL)
