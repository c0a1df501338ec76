"""The port's recurrent LMs (rwkv6-1.6b, zamba2-1.2b) against the reference
at smoke size, with the reference's parameters converted through
``repro_torch.models.convert``: prefill logits and every cache / state leaf,
teacher-forced decode, and the invariants of tests/test_models.py:50,93
(decode == full forward, prefill at a prefix offset).  On the CPU the WKV,
SSD, flash and paged decode wrappers run their plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from parity_harness import jax_params_to_torch, np32

from repro.configs import get_config
from repro.models import api as jax_api
from repro_torch.models import api, transformer

RECURRENT = ["rwkv6-1.6b", "zamba2-1.2b"]
B, S = 2, 12

# Tolerances, each with its reason.
# f32 parameters and caches: both packages run the same f32 arithmetic with
# sums in another order; two layers stay within 1e-4 of each other.
F32_MODEL_TOL = 1e-4
# bf16 (the models' own dtypes): XLA's CPU fusions keep f32 between
# elementwise ops where torch rounds each one to bf16, so r/k/v/w or the
# Mamba-2 projections may differ by a bf16 step (2^-8 of the value); the
# f32 states integrate that over the sequence and the decode steps, and
# two layers move logits and states by up to ~4 % of their range (worst
# seen 0.15 at max |logit| ~4, |wkv| ~8).  The f32 cases above hold the
# arithmetic itself to 1e-4.
BF16_MODEL_TOL = 0.25


def _setup(arch, seed=0, f32=False):
    cfg = get_config(arch, smoke=True)
    jparams = jax_api.init_params(cfg, jax.random.key(seed))
    if f32:
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    tparams = jax_params_to_torch(jparams, "cpu")
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return cfg, jparams, tparams, toks


def _caches(cfg, max_seq, f32):
    jc = jax_api.init_cache(cfg, B, max_seq)
    tc = api.init_cache(cfg, B, max_seq, "cpu")
    if f32:  # every leaf in f32, the attention cache included
        jc = jax.tree.map(lambda a: a.astype(jnp.float32), jc)
        tc = {k: v.float() for k, v in tc.items()}
    return jc, tc


def _assert_cache_close(tc, jc, tol):
    assert set(tc) == set(jc)
    for name, want in jc.items():
        got = tc[name]
        assert got.dtype == {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}[want.dtype.type], name
        if name.startswith("attn_"):  # the port rounds S_max up to whole 16-slot pages
            assert got.shape[2] % 16 == 0 and not got[:, :, want.shape[2]:].any()
            got = got[:, :, :want.shape[2]]
        np.testing.assert_allclose(np32(got), np32(want), rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_prefill_and_states_match_reference(arch, f32):
    cfg, jparams, tparams, toks = _setup(arch, f32=f32)
    tol = F32_MODEL_TOL if f32 else BF16_MODEL_TOL
    jc0, tc0 = _caches(cfg, S, f32)
    jl, jc = jax.jit(jax_api.prefill_fn(cfg))(jparams, {"tokens": jnp.asarray(toks)}, jc0, 0)
    tl, tc = api.prefill_fn(cfg)(tparams, {"tokens": torch.from_numpy(toks).long()}, tc0, 0)
    np.testing.assert_allclose(np32(tl), np32(jl), rtol=tol, atol=tol)
    _assert_cache_close(tc, jc, tol)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_teacher_forced_decode_matches_reference(arch, f32):
    cfg, jparams, tparams, toks = _setup(arch, seed=1, f32=f32)
    tol = F32_MODEL_TOL if f32 else BF16_MODEL_TOL
    half = S // 2
    jc, tc = _caches(cfg, S, f32)
    jpre, jdec = jax.jit(jax_api.prefill_fn(cfg)), jax.jit(jax_api.decode_fn(cfg))
    jl, jc = jpre(jparams, {"tokens": jnp.asarray(toks[:, :half])}, jc, 0)
    tl, tc = api.prefill_fn(cfg)(tparams, {"tokens": torch.from_numpy(toks[:, :half]).long()}, tc, 0)
    for t in range(half, S):
        jl, jc = jdec(jparams, jnp.asarray(toks[:, t:t + 1]), jc, t)
        tl, tc = api.decode_fn(cfg)(tparams, torch.from_numpy(toks[:, t:t + 1]).long(), tc, t)
        np.testing.assert_allclose(np32(tl), np32(jl), rtol=tol, atol=tol)
    _assert_cache_close(tc, jc, tol)


@pytest.mark.parametrize("arch", RECURRENT)
def test_decode_matches_train_forward(arch):
    """Teacher-forced decode through the states reproduces the cache-free
    forward (tests/test_models.py:50, same tolerances)."""
    cfg, _, tparams, toks = _setup(arch, seed=2)
    t = torch.from_numpy(toks).long()
    ref, _, _ = transformer.lm_forward(tparams, cfg, t)
    half = S // 2
    cache = api.init_cache(cfg, B, S + 4, "cpu")
    logits, cache = api.prefill_fn(cfg)(tparams, {"tokens": t[:, :half]}, cache, 0)
    got = [logits]
    for i in range(half, S):
        lg, cache = api.decode_fn(cfg)(tparams, t[:, i:i + 1], cache, i)
        got.append(lg)
    got = torch.cat(got, dim=1)
    np.testing.assert_allclose(np32(got), np32(ref), rtol=0.15, atol=0.15)  # bf16 paths
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    assert agree >= 0.95, f"{arch}: argmax agreement {agree}"


@pytest.mark.parametrize("arch", RECURRENT)
def test_prefill_with_prefix_offset(arch):
    """Two-stage prefill (states carried from the prefix) == single-shot
    prefill (tests/test_models.py:93, same tolerance)."""
    cfg, _, tparams, toks = _setup(arch, seed=3)
    t = torch.from_numpy(toks).long()
    pre = api.prefill_fn(cfg)
    full, _ = pre(tparams, {"tokens": t}, api.init_cache(cfg, B, S, "cpu"), 0)
    cache = api.init_cache(cfg, B, S, "cpu")
    _, cache = pre(tparams, {"tokens": t[:, :6]}, cache, 0)
    tail, _ = pre(tparams, {"tokens": t[:, 6:]}, cache, 6)
    np.testing.assert_allclose(np32(tail), np32(full[:, 6:]), rtol=0.1, atol=0.1)


def test_hybrid_cache_has_one_attention_slot_per_site():
    """zamba2-1.2b at full width: 38 Mamba-2 layers, shared attention at
    every 6th (sites 0..6), k/v of (7, B, S rounded up to 16, 32, 64).
    The config's ``kv_bytes_per_token`` counts 38 // 6 = 6 attention layers
    (a quirk of the reference, kept: ROADMAP.md §3 item 4)."""
    cfg = get_config("zamba2-1.2b")
    assert transformer.n_attn_sites(cfg) == 7
    assert cfg.kv_bytes_per_token == 2 * 32 * 64 * 6 * 2
    specs = transformer.cache_specs(cfg, 1, 130)
    assert specs["attn_k"] == ((7, 1, 144, 32, 64), torch.bfloat16)
    assert specs["ssm"] == ((38, 1, 64, 64, 64), torch.float32)
    assert specs["conv"] == ((38, 1, 3, 2 * 2048 + 2 * 64), torch.bfloat16)
