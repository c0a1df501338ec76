"""The port's dense decoders against the reference at smoke size, with the
reference's parameters converted through ``repro_torch.models.convert``:
prefill logits and k/v cache, teacher-forced decode, the invariants of
tests/test_models.py (decode == full forward, prefill at a prefix offset),
and the embedding of ids past the vocabulary."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from parity_harness import MODEL_TOL, jax_params_to_torch, np32

from repro.configs import get_config
from repro.models import api as jax_api
from repro.models import transformer as jax_transformer
from repro_torch.models import api
from repro_torch.models import transformer
from repro_torch.models.transformer import embed_tokens

DENSE = ["qwen3-14b", "glm4-9b", "qwen2.5-32b", "chameleon-34b"]
B, S = 2, 12


def _setup(arch, seed=0):
    cfg = get_config(arch, smoke=True)
    jparams = jax_api.init_params(cfg, jax.random.key(seed))
    tparams = jax_params_to_torch(jparams, "cpu")
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return cfg, jparams, tparams, toks


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_cache_match_reference(arch):
    cfg, jparams, tparams, toks = _setup(arch)
    jl, jc = jax.jit(jax_api.prefill_fn(cfg))(jparams, {"tokens": jnp.asarray(toks)},
                                              jax_api.init_cache(cfg, B, S), 0)
    tl, tc = api.prefill_fn(cfg)(tparams, {"tokens": torch.from_numpy(toks).long()},
                                 api.init_cache(cfg, B, S, "cpu"), 0)
    assert tl.dtype == torch.bfloat16 and tc["k"].dtype == torch.bfloat16
    assert tc["k"].shape[2] == 16  # S_max rounded up to whole decode pages
    np.testing.assert_allclose(np32(tl), np32(jl), rtol=MODEL_TOL, atol=MODEL_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(np32(tc[name][:, :, :S]), np32(jc[name]), rtol=MODEL_TOL, atol=MODEL_TOL)
        assert not tc[name][:, :, S:].any()  # the rounding slots stay untouched


@pytest.mark.parametrize("arch", DENSE)
def test_teacher_forced_decode_matches_reference(arch):
    cfg, jparams, tparams, toks = _setup(arch, seed=1)
    half = S // 2
    jpre, jdec = jax.jit(jax_api.prefill_fn(cfg)), jax.jit(jax_api.decode_fn(cfg))
    jl, jc = jpre(jparams, {"tokens": jnp.asarray(toks[:, :half])}, jax_api.init_cache(cfg, B, S), 0)
    tpre, tdec = api.prefill_fn(cfg), api.decode_fn(cfg)
    tl, tc = tpre(tparams, {"tokens": torch.from_numpy(toks[:, :half]).long()},
                  api.init_cache(cfg, B, S, "cpu"), 0)
    for t in range(half, S):
        jl, jc = jdec(jparams, jnp.asarray(toks[:, t:t + 1]), jc, t)
        tl, tc = tdec(tparams, torch.from_numpy(toks[:, t:t + 1]).long(), tc, t)
        np.testing.assert_allclose(np32(tl), np32(jl), rtol=MODEL_TOL, atol=MODEL_TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_train_forward(arch):
    """Teacher-forced decode through the cache path reproduces the
    cache-free forward (tests/test_models.py:50, same tolerances)."""
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


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_with_prefix_offset(arch):
    """Two-stage prefill (cached prefix + suffix compute) == single-shot
    prefill (tests/test_models.py:93, same tolerance)."""
    cfg, _, tparams, toks = _setup(arch, seed=3)
    t = torch.from_numpy(toks).long()
    pre = api.prefill_fn(cfg)
    full, _ = pre(tparams, {"tokens": t}, api.init_cache(cfg, B, S, "cpu"), 0)
    cache = api.init_cache(cfg, B, S, "cpu")
    _, cache = pre(tparams, {"tokens": t[:, :6]}, cache, 0)
    tail, _ = pre(tparams, {"tokens": t[:, 6:]}, cache, 6)
    np.testing.assert_allclose(np32(tail), np32(full[:, 6:]), rtol=0.1, atol=0.1)


def test_ids_past_the_vocabulary_embed_like_the_reference():
    """The reference's gather clamps ids >= V to the last row (the staged
    workload draws ids up to 50,000 for a 256-token smoke vocabulary); the
    port clamps the same way instead of raising."""
    cfg, jparams, tparams, _ = _setup("qwen3-14b")
    ids = np.array([[0, 5, cfg.vocab_size - 1, cfg.vocab_size, cfg.vocab_size + 5, 49_999]], np.int32)
    want = np32(jparams["embed"][jnp.asarray(ids)])
    got = np32(embed_tokens(tparams["embed"], torch.from_numpy(ids).long()))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 3:], np.repeat(got[0, 2:3], 3, axis=0))
    jl, _, _ = jax_transformer.lm_forward(jparams, cfg, jnp.asarray(ids))
    tl, _, _ = transformer.lm_forward(tparams, cfg, torch.from_numpy(ids).long())
    np.testing.assert_allclose(np32(tl), np32(jl), rtol=MODEL_TOL, atol=MODEL_TOL)


def test_param_tree_matches_the_reference_template():
    """Same keys and shapes as the reference's params, for a dense and the
    two recurrent families (zamba2's shared attention block included);
    seeded init on the requested device, deterministic per seed."""

    def walk(t, prefix=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from walk(v, f"{prefix}['{k}']")
        else:
            yield prefix, tuple(t.shape)

    for arch in ("qwen3-14b", "rwkv6-1.6b", "zamba2-1.2b"):
        cfg = get_config(arch, smoke=True)
        jparams = jax_api.init_params(cfg, jax.random.key(0))
        ours = api.init_params(cfg, 0, "cpu")
        flat = {jax.tree_util.keystr(p): a.shape for p, a in jax.tree_util.tree_leaves_with_path(jparams)}
        assert dict(walk(ours)) == {k: tuple(v) for k, v in flat.items()}, arch
        assert ours["embed"].device.type == "cpu" and ours["embed"].dtype == torch.bfloat16
    cfg = get_config("qwen3-14b", smoke=True)
    ours, again = api.init_params(cfg, 0, "cpu"), api.init_params(cfg, 0, "cpu")
    assert torch.equal(ours["blocks"]["attn"]["wq"], again["blocks"]["attn"]["wq"])


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "kimi-k2-1t-a32b", "minicpm3-4b", "whisper-small"])
def test_moe_and_mla_param_trees_match_the_reference_template(arch):
    """The moe, mla and encdec templates give the reference's keys, shapes
    and dtypes, so ``models.convert`` carries the reference's parameters
    across."""
    cfg = get_config(arch, smoke=True)
    jparams = jax_api.init_params(cfg, jax.random.key(0))
    flat = {jax.tree_util.keystr(p): tuple(a.shape) for p, a in jax.tree_util.tree_leaves_with_path(jparams)}
    ours = jax_params_to_torch(jparams, "cpu")
    mine = api.init_params(cfg, 0, "cpu")

    def walk(t, prefix=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from walk(v, f"{prefix}['{k}']")
        else:
            yield prefix, (tuple(t.shape), t.dtype)

    assert {k: v[0] for k, v in walk(mine)} == flat
    assert {k: v[1] for k, v in walk(mine)} == {k: v[1] for k, v in walk(ours)}  # router f32, the rest bf16
