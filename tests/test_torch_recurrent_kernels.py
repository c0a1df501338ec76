"""The port's WKV (RWKV6) and SSD (Mamba-2) scans against the reference, on
the same numpy inputs: the sequential oracles (``wkv_ref``, ``ssd_ref``),
the reference ops with their Pallas kernels in interpret mode, and the
model's chunked scans (``models/ssm.py::wkv_chunked``,
``::mamba2_ssd_chunked``).  On the CPU every wrapper runs its plain
version; the kernels themselves are held against those plain versions on
the card (tests/test_torch_cuda_kernels.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from parity_harness import F32_TOL, jax_from, np32, torch_from

from repro.kernels.mamba2 import ssd as jax_ssd
from repro.kernels.mamba2 import ssd_ref as jax_ssd_ref
from repro.kernels.rwkv6 import wkv as jax_wkv
from repro.kernels.rwkv6 import wkv_ref as jax_wkv_ref
from repro.models import ssm as jax_ssm
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.mamba2 import ssd, ssd_chunked, ssd_chunked_plain, ssd_ref
from repro_torch.kernels.rwkv6 import wkv, wkv_model, wkv_ref

# Tolerances, each with its reason.  Both packages compute each function in
# f32 with the same operations, in another summation order.
# The reference kernel tests' own tolerances (tests/test_kernels.py:104,141):
# the closed forms against the sequential oracles.
WKV_TOL = 3e-4
SSD_TOL = 4e-4
# Where the log-decay clamp acts, exp(-cum) reaches e^80: a relative error
# of one f32 step in cum (|cum| <= 80) becomes ~1e-5 of a term; the terms
# themselves stay bounded, so the results agree to about that.
CLAMP_TOL = 1e-4
# A 256-step SSD chunk: cum reaches about -200, and the reference takes its
# cumulative sum in another order (an associative scan) than the port (one
# f32 add per step), which moves exp(cum_t - cum_j) by ~1e-5 of itself;
# terms reach ~30, so the kernel tests' own tolerance applies.
LONG_CHUNK_TOL = SSD_TOL


def _wkv_inputs(seed, B, H, S, N, w_lo=0.45, w_hi=0.95, layout="bhsn"):
    """r/k/v ~ N(0,1), w in (w_lo, w_hi), u, state; (B,H,S,N) or (B,S,H,N)."""
    rng = np.random.default_rng(seed)
    shape = (B, H, S, N) if layout == "bhsn" else (B, S, H, N)
    r, k, v = (rng.standard_normal(shape) for _ in range(3))
    w = w_lo + (w_hi - w_lo) / (1 + np.exp(-rng.standard_normal(shape)))
    u = rng.standard_normal((H, N)) * 0.3
    s0 = rng.standard_normal((B, H, N, N)) * 0.5
    return r, k, v, w, u, s0


def _model_decay(seed, shape):
    """w as the model draws it at full width: exp(-exp(w0 + xw)) with xw
    about N(0,1) and w0 near 0, so log w < -5 in ~5 % of the entries."""
    xw = np.random.default_rng(seed).standard_normal(shape)
    return np.exp(-np.exp(xw))


def _t(*arrays):
    return [torch_from(a) for a in arrays]


def _j(*arrays):
    return [jax_from(a) for a in arrays]


# ------------------------------------------------------------------- WKV
@pytest.mark.parametrize("B,H,S,N", [(2, 3, 37, 16), (1, 2, 5, 8)])
def test_wkv_ref_matches_reference_oracle(B, H, S, N):
    ins = _wkv_inputs(S, B, H, S, N)
    y, s = wkv_ref(*_t(*ins))
    yj, sj = jax_wkv_ref(*_j(*ins))
    np.testing.assert_allclose(np32(y), np32(yj), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(np32(s), np32(sj), rtol=F32_TOL, atol=F32_TOL)


# the reference kernel test's cases (tests/test_kernels.py:93) and one
# with S < chunk, where the op shrinks its chunk to S
@pytest.mark.parametrize("B,H,S,N,chunk", [(2, 3, 37, 16, 8), (1, 2, 64, 32, 32), (2, 4, 100, 64, 16),
                                           (1, 2, 20, 16, 32)])
def test_wkv_op_matches_reference_kernel_and_oracle(B, H, S, N, chunk):
    ins = _wkv_inputs(S * 10 + N, B, H, S, N)
    y, s = wkv(*_t(*ins), chunk=chunk)
    yj, sj = jax_wkv(*_j(*ins), chunk=chunk, interpret=True)
    np.testing.assert_allclose(np32(y), np32(yj), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(np32(s), np32(sj), rtol=F32_TOL, atol=F32_TOL)
    yr, sr = wkv_ref(*_t(*ins))  # w >= 0.45: the clamp never acts
    np.testing.assert_allclose(np32(y), np32(yr), rtol=WKV_TOL, atol=WKV_TOL)
    np.testing.assert_allclose(np32(s), np32(sr), rtol=WKV_TOL, atol=WKV_TOL)


def test_wkv_clamp_makes_the_chunk_part_of_the_function():
    """With the model's decay, log w < -5 in some channels: chunk 16 clamps
    there and chunk 32 (clamp -2.5) clamps more, so the two differ, in both
    packages alike; each chunk matches its reference counterpart."""
    B, S, H, N = 1, 48, 2, 16
    r, k, v, _, u, s0 = _wkv_inputs(5, B, H, S, N, layout="bshn")
    w = _model_decay(6, (B, S, H, N))
    assert (np.log(w) < -80 / 16).mean() > 0.02  # the chunk-16 clamp acts
    ins = (r, k, v, w, u, s0)
    y16, s16 = wkv_model(*_t(*ins), chunk=16)
    y16j, s16j = jax_ssm.wkv_chunked(*_j(*ins), chunk=16)
    np.testing.assert_allclose(np32(y16), np32(y16j), rtol=CLAMP_TOL, atol=CLAMP_TOL)
    np.testing.assert_allclose(np32(s16), np32(s16j), rtol=CLAMP_TOL, atol=CLAMP_TOL)
    # chunk 32 through the op's (B,H,S,N) layout, against the Pallas kernel
    bhsn = [np.swapaxes(a, 1, 2) for a in (r, k, v, w)]
    y32, s32 = wkv(*_t(*bhsn), *_t(u, s0), chunk=32)
    y32j, s32j = jax_wkv(*_j(*bhsn), *_j(u, s0), chunk=32, interpret=True)
    np.testing.assert_allclose(np32(y32), np32(y32j), rtol=CLAMP_TOL, atol=CLAMP_TOL)
    np.testing.assert_allclose(np32(s32), np32(s32j), rtol=CLAMP_TOL, atol=CLAMP_TOL)
    gap, gap_j = np.abs(np32(y16) - np.swapaxes(np32(y32), 1, 2)).max(), \
        np.abs(np32(y16j) - np.swapaxes(np32(y32j), 1, 2)).max()
    assert gap > 100 * CLAMP_TOL and gap_j > 100 * CLAMP_TOL
    np.testing.assert_allclose(gap, gap_j, rtol=1e-2)


def test_wkv_model_layout_pads_like_wkv_chunked():
    """bf16 r/k/v and f32 w in (B,S,H,N), a ragged S and a carried state,
    against ``models/ssm.py::wkv_chunked`` at the model's chunk."""
    B, S, H, N = 2, 37, 3, 16
    r, k, v, _, u, s0 = _wkv_inputs(9, B, H, S, N, layout="bshn")
    w = _model_decay(10, (B, S, H, N))
    rt, kt, vt = (torch_from(a, torch.bfloat16) for a in (r, k, v))
    y, s = wkv_model(rt, kt, vt, *_t(w, u, s0))
    rj, kj, vj = (jax_from(a, jnp.bfloat16) for a in (r, k, v))
    yj, sj = jax_ssm.wkv_chunked(rj, kj, vj, *_j(w, u, s0))
    assert y.shape == (B, S, H, N) and y.dtype == torch.float32
    np.testing.assert_allclose(np32(y), np32(yj), rtol=CLAMP_TOL, atol=CLAMP_TOL)
    np.testing.assert_allclose(np32(s), np32(sj), rtol=CLAMP_TOL, atol=CLAMP_TOL)


def test_wkv_state_chains_across_two_calls():
    """Two halves with the state carried == one run (tests/test_kernels.py:110),
    and the halves match the reference op's."""
    B, H, S, N = 1, 2, 64, 16
    r, k, v, w, u, _ = _wkv_inputs(11, B, H, S, N, 0.55, 0.95)
    s0 = np.zeros((B, H, N, N))
    h = S // 2
    y_full, s_full = wkv(*_t(r, k, v, w, u, s0), chunk=16)
    y1, s1 = wkv(*_t(r[:, :, :h], k[:, :, :h], v[:, :, :h], w[:, :, :h], u, s0), chunk=16)
    y2, s2 = wkv(*_t(r[:, :, h:], k[:, :, h:], v[:, :, h:], w[:, :, h:], u), s1, chunk=16)
    np.testing.assert_allclose(np32(y_full[:, :, :h]), np32(y1), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np32(y_full[:, :, h:]), np32(y2), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np32(s_full), np32(s2), rtol=1e-4, atol=1e-4)
    _, s1j = jax_wkv(*_j(r[:, :, :h], k[:, :, :h], v[:, :, :h], w[:, :, :h], u, s0), chunk=16, interpret=True)
    y2j, s2j = jax_wkv(*_j(r[:, :, h:], k[:, :, h:], v[:, :, h:], w[:, :, h:], u), s1j, chunk=16, interpret=True)
    np.testing.assert_allclose(np32(y2), np32(y2j), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(np32(s2), np32(s2j), rtol=F32_TOL, atol=F32_TOL)


# ------------------------------------------------------------------- SSD
def _ssd_inputs(seed, B, S, H, P, N, state_scale=0.5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P))
    Bm, Cm = rng.standard_normal((B, S, N)), rng.standard_normal((B, S, N))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))
    a = np.exp(-dt * np.exp(rng.standard_normal((H,))[None, None] * 0.3))
    s0 = rng.standard_normal((B, H, P, N)) * state_scale
    return x, Bm, Cm, a, dt, s0


@pytest.mark.parametrize("B,S,H,P,N", [(2, 50, 3, 8, 16), (1, 7, 2, 4, 8)])
def test_ssd_ref_matches_reference_oracle(B, S, H, P, N):
    ins = _ssd_inputs(S, B, S, H, P, N)
    y, s = ssd_ref(*_t(*ins))
    yj, sj = jax_ssd_ref(*_j(*ins))
    np.testing.assert_allclose(np32(y), np32(yj), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(np32(s), np32(sj), rtol=F32_TOL, atol=F32_TOL)


# the reference kernel test's cases (tests/test_kernels.py:128), then
# S < chunk (the op shrinks its chunk to S) and the full model's P = N = 64
@pytest.mark.parametrize("B,S,H,P,N,chunk", [(2, 50, 3, 8, 16, 16), (1, 128, 2, 16, 8, 64),
                                             (1, 24, 2, 8, 8, 64), (1, 70, 2, 64, 64, 32)])
def test_ssd_op_matches_reference_kernel_and_oracle(B, S, H, P, N, chunk):
    ins = _ssd_inputs(S + P, B, S, H, P, N)
    y, s = ssd(*_t(*ins), chunk=chunk)
    yj, sj = jax_ssd(*_j(*ins), chunk=chunk, interpret=True)
    np.testing.assert_allclose(np32(y), np32(yj), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(np32(s), np32(sj), rtol=F32_TOL, atol=F32_TOL)
    yr, sr = ssd_ref(*_t(*ins))
    np.testing.assert_allclose(np32(y), np32(yr), rtol=SSD_TOL, atol=SSD_TOL)
    np.testing.assert_allclose(np32(s), np32(sr), rtol=SSD_TOL, atol=SSD_TOL)


@pytest.mark.parametrize("S", [50, 300])
def test_ssd_chunked_matches_mamba2_ssd_chunked(S):
    """bf16 x/B/C and f32 a/dt at the model's chunk of 256: one ragged
    chunk, then two chunks with the state carried between them."""
    B, H, P, N = 2, 3, 16, 8
    x, Bm, Cm, a, dt, s0 = _ssd_inputs(S, B, S, H, P, N)
    xt, bt, ct = (torch_from(t, torch.bfloat16) for t in (x, Bm, Cm))
    y, s = ssd_chunked(xt, bt, ct, *_t(a, dt, s0))
    xj, bj, cj = (jax_from(t, jnp.bfloat16) for t in (x, Bm, Cm))
    yj, sj = jax_ssm.mamba2_ssd_chunked(xj, bj, cj, *_j(a, dt, s0))
    assert y.shape == (B, S, H, P) and y.dtype == torch.float32
    np.testing.assert_allclose(np32(y), np32(yj), rtol=LONG_CHUNK_TOL, atol=LONG_CHUNK_TOL)
    np.testing.assert_allclose(np32(s), np32(sj), rtol=LONG_CHUNK_TOL, atol=LONG_CHUNK_TOL)
    # every chunk length computes the same recurrence up to f32 rounding
    y64, s64 = ssd_chunked_plain(xt, bt, ct, *_t(a, dt, s0), chunk=64)
    np.testing.assert_allclose(np32(y), np32(y64), rtol=SSD_TOL, atol=SSD_TOL)
    np.testing.assert_allclose(np32(s), np32(s64), rtol=SSD_TOL, atol=SSD_TOL)


def test_ssd_state_chains_across_two_calls():
    """Two halves with the state carried == one run (tests/test_kernels.py:147)."""
    B, S, H, P, N = 1, 64, 2, 8, 16
    x, Bm, Cm, _, dt, _ = _ssd_inputs(3, B, S, H, P, N)
    a, s0 = np.exp(-dt * 0.8), np.zeros((B, H, P, N))
    h = S // 2
    y_full, s_full = ssd(*_t(x, Bm, Cm, a, dt, s0), chunk=16)
    y1, s1 = ssd(*_t(x[:, :h], Bm[:, :h], Cm[:, :h], a[:, :h], dt[:, :h], s0), chunk=16)
    y2, s2 = ssd(*_t(x[:, h:], Bm[:, h:], Cm[:, h:], a[:, h:], dt[:, h:]), s1, chunk=16)
    np.testing.assert_allclose(np32(y_full[:, :h]), np32(y1), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np32(y_full[:, h:]), np32(y2), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np32(s_full), np32(s2), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ the wrappers
def test_wrappers_take_the_plain_versions_on_the_cpu_only():
    """CPU tensors run the plain versions (no launch is counted); a device
    that is neither the CPU nor CUDA raises instead of falling back."""
    reset_launch_counts()
    wkv(*_t(*_wkv_inputs(0, 1, 2, 8, 4)))
    ssd(*_t(*_ssd_inputs(0, 1, 8, 2, 4, 4)))
    counts = launch_counts()
    assert counts["wkv"] == 0 and counts["ssd"] == 0
    meta = [torch.zeros(1, 4, 2, 8, device="meta") for _ in range(4)]
    with pytest.raises(ValueError, match="runs on cuda"):
        wkv_model(*meta, torch.zeros(2, 8, device="meta"), torch.zeros(1, 2, 8, 8, device="meta"))
    with pytest.raises(ValueError, match="runs on cuda"):
        ssd(torch.zeros(1, 4, 2, 8, device="meta"), *[torch.zeros(1, 4, 4, device="meta")] * 2,
            *[torch.zeros(1, 4, 2, device="meta")] * 2, torch.zeros(1, 2, 8, 4, device="meta"))


def test_wrappers_refuse_mismatched_shapes_and_types():
    r, k, v, w, u, s0 = _t(*_wkv_inputs(0, 1, 2, 8, 4, layout="bshn"))
    with pytest.raises(ValueError, match="shape mismatch"):
        wkv_model(r, k[:, :4], v, w, u, s0)
    with pytest.raises(ValueError, match="u must be"):
        wkv_model(r, k, v, w, u, s0[:, :1])
    with pytest.raises(TypeError, match="share one of"):
        wkv_model(r, k.to(torch.bfloat16), v, w, u, s0)
    x, Bm, Cm, a, dt, st = _t(*_ssd_inputs(0, 1, 8, 2, 4, 4))
    with pytest.raises(ValueError, match="shape mismatch"):
        ssd(x, Bm, Cm[:, :4], a, dt, st)
    with pytest.raises(ValueError, match="at least one step"):
        ssd(x[:, :0], Bm[:, :0], Cm[:, :0], a[:, :0], dt[:, :0], st)
