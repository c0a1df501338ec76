"""The port's step builders (``repro_torch.launch.steps``) against the
reference's (``repro.launch.steps``) at smoke size on the CPU, with the
reference's parameters converted through ``repro_torch.models.convert`` and
the same numpy inputs on both sides: the prefill step (last-token logits
and every cache leaf) against the jitted reference step, four decode steps
at a tensor ``pos`` against the jitted reference step at a traced ``pos``,
the tensor-``pos`` decode against the int-``pos`` decode bit for bit, the
optimizer choice, the remat config and one train step.  On the CPU
``capture`` returns the step itself, which is what runs here; the
captured graphs are held against eager steps on the card
(tests/test_torch_cuda_steps.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from parity_harness import MODEL_TOL, jax_params_to_torch, np32, torch_from

from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.launch import steps as jax_steps
from repro.models import api as jax_api
from repro.training import optim as jax_optim
from repro_torch.launch import steps
from repro_torch.models import api
from repro_torch.models.common import tree_flatten
from repro_torch.training import optim
from repro_torch.training.data import DataConfig, SyntheticLM

ARCHS = ["qwen3-14b", "glm4-9b", "olmoe-1b-7b", "minicpm3-4b", "rwkv6-1.6b", "zamba2-1.2b", "whisper-small"]
DTYPES = pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
B, S, N_DECODE = 2, 12, 4

# Tolerances, each with its reason: the ones the existing parity tests use
# for each family.
# dense, moe and MLA in bf16 (tests/parity_harness.py): matmuls round to
# bf16 at other places in XLA and in torch
# rwkv6 and zamba2 in bf16 (tests/test_torch_recurrent_models.py): the f32
# states integrate a bf16 step of r/k/v/w or of the Mamba-2 projections
BF16_RECURRENT_TOL = 0.25
# every family with f32 parameters and caches: the same f32 arithmetic,
# sums in another order
F32_MODEL_TOL = 1e-4
# whisper in bf16 (tests/test_torch_encdec.py): MODEL_TOL, its atol a share
# of the largest |value|, since a few bf16 steps of the largest logit land
# on logits near zero too


def _close(got, want, cfg, f32, what=""):
    got, want = np32(got), np32(want)
    if f32:
        tol, atol = F32_MODEL_TOL, F32_MODEL_TOL
    elif cfg.family in ("rwkv6", "hybrid"):
        tol, atol = BF16_RECURRENT_TOL, BF16_RECURRENT_TOL
    elif cfg.family == "encdec":
        tol, atol = MODEL_TOL, MODEL_TOL * float(np.abs(want).max())
    else:
        tol, atol = MODEL_TOL, MODEL_TOL
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol, err_msg=what)


def _setup(arch, seed=0, f32=False):
    cfg = get_config(arch, smoke=True)
    jparams = jax_api.init_params(cfg, jax.random.key(seed))
    if f32:
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = rng.standard_normal((B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return cfg, jparams, jax_params_to_torch(jparams, "cpu"), toks, frames


def _inputs(cfg, toks, frames, f32=False):
    """The same prefill batch for both packages: tokens, and frames for encdec."""
    j, t = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks).long()}
    if cfg.family == "encdec":
        j["frames"] = jnp.asarray(frames, jnp.float32 if f32 else jnp.bfloat16)
        t["frames"] = torch_from(frames, torch.float32 if f32 else torch.bfloat16)
    return j, t


def _assert_cache_close(tc, jc, cfg, f32):
    """Every cache leaf; the port rounds the sequence axis (axis 2) of its
    attention caches up to whole 16-slot pages, and those slots stay zero."""
    assert set(tc) == set(jc)
    for name, want in jc.items():
        got = tc[name]
        if got.shape != want.shape:
            assert got.shape[2] % 16 == 0 and not got[:, :, want.shape[2]:].any(), name
            got = got[:, :, :want.shape[2]]
        _close(got, want, cfg, f32, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_reference(arch):
    """``build_prefill_step`` against ``jax.jit(steps.build_prefill_step)``:
    the step makes its own cache, prefills at 0 and returns the last
    token's logits (B, V) and the cache."""
    cfg, jparams, tparams, toks, frames = _setup(arch)
    shape = ShapeConfig("prefill_test", S, B, "prefill")
    jin, tin = _inputs(cfg, toks, frames)
    jl, jc = jax.jit(jax_steps.build_prefill_step(cfg, shape))(jparams, jin)
    tl, tc = steps.build_prefill_step(cfg, shape)(tparams, tin)
    assert tl.shape == (B, cfg.vocab_size) and tuple(jl.shape) == (B, cfg.vocab_size)
    _close(tl, jl, cfg, False, "logits")
    _assert_cache_close(tc, jc, cfg, False)


def _prefilled(cfg, jparams, tparams, toks, frames, f32):
    """Both packages' caches after a prefill of the first S - N_DECODE
    tokens (f32 leaves when ``f32``)."""
    jc, tc = jax_api.init_cache(cfg, B, S), api.init_cache(cfg, B, S, "cpu")
    if f32:
        jc = jax.tree.map(lambda a: a.astype(jnp.float32), jc)
        tc = {k: v.float() for k, v in tc.items()}
    half = S - N_DECODE
    jin, tin = _inputs(cfg, toks[:, :half], frames, f32)
    _, jc = jax.jit(jax_api.prefill_fn(cfg))(jparams, jin, jc, 0)
    _, tc = api.prefill_fn(cfg)(tparams, tin, tc, 0)
    return jc, tc


@DTYPES
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_at_a_tensor_pos_matches_reference(arch, f32):
    """Four ``build_decode_step`` steps with ``pos`` a 0-d int32 tensor
    against the jitted reference step at a traced ``pos``: the logits of
    every step and every cache leaf after."""
    cfg, jparams, tparams, toks, frames = _setup(arch, seed=1, f32=f32)
    shape = ShapeConfig("decode_test", S, B, "decode")
    jc, tc = _prefilled(cfg, jparams, tparams, toks, frames, f32)
    jstep = jax.jit(jax_steps.build_decode_step(cfg, shape))
    tstep = steps.build_decode_step(cfg, shape)
    for t in range(S - N_DECODE, S):
        jl, jc = jstep(jparams, jnp.asarray(toks[:, t:t + 1]), jc, jnp.int32(t))
        tl, tc = tstep(tparams, torch.from_numpy(toks[:, t:t + 1]).long(), tc, torch.tensor(t, dtype=torch.int32))
        assert tl.shape == (B, cfg.vocab_size)
        _close(tl, jl, cfg, f32, f"logits at pos {t}")
    _assert_cache_close(tc, jc, cfg, f32)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_at_a_tensor_pos_equals_int_pos_bit_for_bit(arch):
    """The decode a captured graph replays (``pos`` a tensor: the cache
    written with ``index_copy_``, kv_len built on the device, MLA masked
    over every slot) against the int-``pos`` decode: the same logits and
    caches, bit for bit, on the CPU."""
    cfg, jparams, tparams, toks, frames = _setup(arch, seed=2)
    step = steps.build_decode_step(cfg, ShapeConfig("decode_test", S, B, "decode"))
    runs = []
    for tensor_pos in (False, True):
        _, cache = _prefilled(cfg, jparams, tparams, toks, frames, False)
        logits = []
        for t in range(S - N_DECODE, S):
            pos = torch.tensor(t, dtype=torch.int32) if tensor_pos else t
            lg, cache = step(tparams, torch.from_numpy(toks[:, t:t + 1]).long(), cache, pos)
            logits.append(lg)
        runs.append((torch.stack(logits), cache))
    (a, ca), (b, cb) = runs
    assert torch.equal(a, b)
    assert all(torch.equal(ca[k], cb[k]) for k in ca)


def test_a_tensor_pos_is_for_decode_only():
    cfg = get_config("qwen3-14b", smoke=True)
    params = api.init_params(cfg, 0, "cpu")
    cache = api.init_cache(cfg, 1, 8, "cpu")
    with pytest.raises(ValueError, match="tensor pos"):
        api.prefill_fn(cfg)(params, {"tokens": torch.zeros((1, 4), dtype=torch.long)}, cache, torch.tensor(0))
    with pytest.raises(ValueError, match="tensor pos"):
        api.decode_fn(cfg)(params, torch.zeros((1, 1), dtype=torch.long), cache, torch.tensor([3]))


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "qwen3-14b"])
def test_opt_config_and_train_config_match_reference(arch):
    """1T-class kimi-k2 gets bf16 m and a factored v, qwen3-14b f32 AdamW;
    the train config turns remat (and the sharding hint seq_shard) on."""
    cfg = get_config(arch)
    got, want = steps.opt_config_for(cfg), jax_steps.opt_config_for(cfg)
    assert got.__dict__ == want.__dict__
    big = arch.startswith("kimi")
    assert (got.moment_dtype, got.factored_second_moment) == (("bfloat16", True) if big else ("float32", False))
    tcfg, jcfg = steps._train_cfg(cfg), jax_steps._train_cfg(cfg)
    assert tcfg == jcfg and tcfg.remat and tcfg.seq_shard and not cfg.remat


@DTYPES
def test_train_step_matches_reference(f32):
    """One ``build_train_step`` step (remat on, the optimizer
    ``opt_config_for`` picks) against the reference's jitted one on the
    same parameters and batch: loss, ce, aux, grad norm and lr, and (f32)
    every parameter and moment after the step."""
    cfg = get_config("qwen3-14b", smoke=True)
    jparams = jax_api.init_params(cfg, jax.random.key(3))
    if f32:
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    tparams = jax_params_to_torch(jparams, "cpu")
    jstep, jocfg = jax_steps.build_train_step(cfg)
    tstep, tocfg = steps.build_train_step(cfg)
    assert tocfg.__dict__ == jocfg.__dict__
    batch = SyntheticLM(DataConfig(cfg.vocab_size, seq_len=32, global_batch=4, seed=3)).batch_at(0)
    jp, js, jm = jax.jit(jstep)(jparams, jax_optim.init_state(jocfg, jparams),
                                {k: jnp.asarray(a) for k, a in batch.items()})
    tp, ts, tm = tstep(tparams, optim.init_state(tocfg, tparams), {k: torch.from_numpy(a) for k, a in batch.items()})
    assert set(tm) == set(jm) == {"loss", "ce", "aux", "grad_norm", "lr"}
    tol = 1e-5 if f32 else MODEL_TOL  # a scalar mean of f32 log-probabilities; bf16 as the model tests
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    for k in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=tol, atol=tol, err_msg=k)
    if f32:
        for got, want in zip(tree_flatten(tp)[0], jax.tree.leaves(jp)):
            np.testing.assert_allclose(np32(got), np32(want), rtol=F32_MODEL_TOL, atol=F32_MODEL_TOL)
        for got, want in zip(tree_flatten(ts["m"])[0], jax.tree.leaves(js["m"])):
            np.testing.assert_allclose(np32(got), np32(want), rtol=F32_MODEL_TOL, atol=F32_MODEL_TOL)


def test_capture_on_the_cpu_is_the_step_itself():
    """On the CPU ``capture`` hands back the step (the CPU path the tests
    ask for by device, not a fallback); mixed devices and other device
    types raise."""
    def fn(x, y):
        return x + y

    x = torch.ones(3)
    assert steps.capture(fn, x, x, held=(0,)) is fn
    with pytest.raises(ValueError, match="one device"):
        steps.capture(fn, x, torch.ones(3, device="meta"))
    with pytest.raises(ValueError, match="not meta"):
        steps.capture(fn, torch.ones(3, device="meta"))
