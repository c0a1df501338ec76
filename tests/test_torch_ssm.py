"""The port's recurrent mixers (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``) on the same inputs, with the reference's
parameters for layer 0 of the smoke models: RWKV6 time mix and channel mix,
Mamba-2 mix and its causal convolution, each at S = 1 (the sequential
decode step) and S > 1 (the chunked scans, which run the kernels' plain
versions on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from parity_harness import BF16_TOL, F32_TOL, jax_params_to_torch, np32

from repro.configs import get_config
from repro.models import api as jax_api
from repro.models import ssm as jax_ssm
from repro_torch.models import ssm

B = 2

# Tolerances, each with its reason.  f32 parameters: both packages compute
# each mixer in f32, with sums in another order (F32_TOL, widened to 1e-4
# for the RWKV6 group norm, which divides by a per-head standard deviation
# that can be small).  bf16 parameters: the matmuls round to bf16 and the
# two packages may round one element a step apart (BF16_TOL).
F32_MIX_TOL = 1e-4


def _layer0(arch, dtype=None):
    cfg = get_config(arch, smoke=True)
    jparams = jax_api.init_params(cfg, jax.random.key(0))
    bp = jax.tree.map(lambda a: a[0], jparams["blocks"])
    if dtype is not None:
        bp = jax.tree.map(lambda a: a.astype(dtype), bp)
    return cfg, bp, jax_params_to_torch(bp, "cpu")


def _x(seed, S, D, jdtype, tdtype):
    x = np.random.default_rng(seed).standard_normal((B, S, D)).astype(np.float32)
    return jnp.asarray(x, jdtype), torch.from_numpy(x).to(tdtype)


def _rwkv6_state(seed, cfg):
    rng = np.random.default_rng(seed)
    shift = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    wkv = (rng.standard_normal((B, cfg.n_heads, cfg.d_head, cfg.d_head)) * 0.5).astype(np.float32)
    return ((jnp.asarray(shift, jnp.bfloat16), jnp.asarray(wkv)),
            (torch.from_numpy(shift).to(torch.bfloat16), torch.from_numpy(wkv)))


CASES = [(1, jnp.float32, torch.float32, F32_MIX_TOL), (13, jnp.float32, torch.float32, F32_MIX_TOL),
         (1, jnp.bfloat16, torch.bfloat16, BF16_TOL), (13, jnp.bfloat16, torch.bfloat16, BF16_TOL)]
IDS = ["S1-f32", "S13-f32", "S1-bf16", "S13-bf16"]


@pytest.mark.parametrize("S,jdt,tdt,tol", CASES, ids=IDS)
def test_rwkv6_time_mix_matches_reference(S, jdt, tdt, tol):
    cfg, jbp, tbp = _layer0("rwkv6-1.6b", None if jdt == jnp.bfloat16 else jnp.float32)
    xj, xt = _x(S, S, cfg.d_model, jdt, tdt)
    js, ts = _rwkv6_state(S + 1, cfg)
    jo, (jshift, jwkv) = jax.jit(lambda p, x, s: jax_ssm.rwkv6_time_mix(p, cfg, x, s))(jbp["time"], xj, js)
    to, (tshift, twkv) = ssm.rwkv6_time_mix(tbp["time"], cfg, xt, ts)
    assert to.dtype == tdt and twkv.dtype == torch.float32
    np.testing.assert_allclose(np32(to), np32(jo), rtol=tol, atol=tol)
    np.testing.assert_array_equal(np32(tshift), np32(jshift))
    np.testing.assert_allclose(np32(twkv), np32(jwkv), rtol=tol, atol=tol)


@pytest.mark.parametrize("S,jdt,tdt,tol", CASES, ids=IDS)
def test_rwkv6_channel_mix_matches_reference(S, jdt, tdt, tol):
    cfg, jbp, tbp = _layer0("rwkv6-1.6b", None if jdt == jnp.bfloat16 else jnp.float32)
    xj, xt = _x(S + 2, S, cfg.d_model, jdt, tdt)
    shift = np.random.default_rng(S).standard_normal((B, cfg.d_model)).astype(np.float32)
    jo, jshift = jax_ssm.rwkv6_channel_mix(jbp["chan"], cfg, xj, jnp.asarray(shift, jdt))
    to, tshift = ssm.rwkv6_channel_mix(tbp["chan"], cfg, xt, torch.from_numpy(shift).to(tdt))
    np.testing.assert_allclose(np32(to), np32(jo), rtol=tol, atol=tol)
    np.testing.assert_array_equal(np32(tshift), np32(jshift))


@pytest.mark.parametrize("S,jdt,tdt,tol", CASES, ids=IDS)
def test_mamba2_mix_matches_reference(S, jdt, tdt, tol):
    cfg, jbp, tbp = _layer0("zamba2-1.2b", None if jdt == jnp.bfloat16 else jnp.float32)
    xj, xt = _x(S + 4, S, cfg.d_model, jdt, tdt)
    d_in, N, H = cfg.expand * cfg.d_model, cfg.ssm_state, cfg.ssm_heads
    rng = np.random.default_rng(S + 5)
    conv = rng.standard_normal((B, cfg.d_conv - 1, d_in + 2 * N)).astype(np.float32)
    s0 = (rng.standard_normal((B, H, d_in // H, N)) * 0.5).astype(np.float32)
    jo, (jconv, jssm) = jax.jit(lambda p, x, c, s: jax_ssm.mamba2_mix(p, cfg, x, (c, s)))(
        jbp["mamba"], xj, jnp.asarray(conv, jdt), jnp.asarray(s0))
    to, (tconv, tssm) = ssm.mamba2_mix(tbp["mamba"], cfg, xt, (torch.from_numpy(conv).to(tdt), torch.from_numpy(s0)))
    assert to.dtype == tdt and tconv.dtype == tdt and tssm.dtype == torch.float32
    np.testing.assert_allclose(np32(to), np32(jo), rtol=tol, atol=tol)
    np.testing.assert_array_equal(np32(tconv), np32(jconv))
    np.testing.assert_allclose(np32(tssm), np32(jssm), rtol=tol, atol=tol)


def test_causal_conv_sums_in_the_reference_order():
    """bf16 depthwise conv: the K products are summed in bf16 in the
    reference's order, so the two agree exactly."""
    rng = np.random.default_rng(0)
    x, w = rng.standard_normal((2, 9, 24)), rng.standard_normal((4, 24)) * 0.3
    b, st = rng.standard_normal(24) * 0.1, rng.standard_normal((2, 3, 24))
    jy, jst = jax.jit(jax_ssm._causal_conv)(*(jnp.asarray(a, jnp.bfloat16) for a in (x, w, b, st)))
    ty, tst = ssm._causal_conv(*(torch.from_numpy(a).to(torch.bfloat16) for a in (x, w, b, st)))
    np.testing.assert_allclose(np32(ty), np32(jy), rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_array_equal(np32(tst), np32(jst))


def test_state_specs_match_the_reference():
    """Same names, shapes and dtypes for the recurrent states (bf16 shifts
    and convolution tail, f32 scan states)."""
    names = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    for arch, jspecs, tspecs in (("rwkv6-1.6b", jax_ssm.rwkv6_state_specs, ssm.rwkv6_state_specs),
                                 ("zamba2-1.2b", jax_ssm.mamba2_state_specs, ssm.mamba2_state_specs)):
        cfg = get_config(arch)
        want = {k: (tuple(v.shape), names[v.dtype.type]) for k, v in jspecs(cfg, 3).items()}
        assert tspecs(cfg, 3) == want, arch


def test_model_scans_route_through_the_kernel_wrappers():
    """``wkv_chunked`` and ``mamba2_ssd_chunked`` give the same on the CPU
    through the wrappers and through the plain versions, at the model's
    chunks (16 and 256), and match the reference's."""
    rng = np.random.default_rng(3)
    r, k, v = (rng.standard_normal((1, 21, 2, 8)).astype(np.float32) for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((1, 21, 2, 8)))).astype(np.float32)
    u, s0 = rng.standard_normal((2, 8)).astype(np.float32) * 0.3, np.zeros((1, 2, 8, 8), np.float32)
    t = [torch.from_numpy(a) for a in (r, k, v, w, u, s0)]
    a, b = ssm.wkv_chunked(*t), ssm.wkv_chunked(*t, plain_kernels=True)
    jy, js = jax_ssm.wkv_chunked(*(jnp.asarray(a_) for a_ in (r, k, v, w, u, s0)))
    for got, want in zip(a, b):
        assert torch.equal(got, want)
    np.testing.assert_allclose(np32(a[0]), np32(jy), rtol=F32_MIX_TOL, atol=F32_MIX_TOL)
    np.testing.assert_allclose(np32(a[1]), np32(js), rtol=F32_MIX_TOL, atol=F32_MIX_TOL)
    x = rng.standard_normal((1, 21, 2, 4)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((1, 21, 8)).astype(np.float32) for _ in range(2))
    dt = np.log1p(np.exp(rng.standard_normal((1, 21, 2)))).astype(np.float32)
    ins = (x, Bm, Cm, np.exp(-dt).astype(np.float32), dt, np.zeros((1, 2, 4, 8), np.float32))
    t = [torch.from_numpy(a_) for a_ in ins]
    a, b = ssm.mamba2_ssd_chunked(*t), ssm.mamba2_ssd_chunked(*t, plain_kernels=True)
    jy, js = jax_ssm.mamba2_ssd_chunked(*(jnp.asarray(a_) for a_ in ins))
    for got, want in zip(a, b):
        assert torch.equal(got, want)
    np.testing.assert_allclose(np32(a[0]), np32(jy), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(np32(a[1]), np32(js), rtol=F32_TOL, atol=F32_TOL)
