"""The port's int8 KV codec (``repro_torch.kernels.kv_codec``: the wrappers,
which run the plain version for CPU tensors, and ``ref.py``) against the
reference's Pallas kernels in interpret mode, its ``quantize_ref`` /
``dequantize_ref`` oracles and the host codec ``core/codec.py``
``quantize_int8``, on the same numpy inputs; plus the zero channel, values
at an exact half step (round half to even) and the device rule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from parity_harness import torch_from

from repro.core.codec import dequantize_int8 as host_dequantize
from repro.core.codec import quantize_int8 as host_quantize
from repro.kernels.kv_codec import dequantize as jax_dequantize
from repro.kernels.kv_codec import dequantize_ref as jax_dequantize_ref
from repro.kernels.kv_codec import quantize as jax_quantize
from repro.kernels.kv_codec import quantize_ref as jax_quantize_ref
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.kv_codec import dequantize, dequantize_ref, quantize, quantize_ref

DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32),
          "f16": (torch.float16, jnp.float16)}
# the reference kernel test's shapes (tests/test_kernels.py:20), a ragged
# C of 1000, and 3 rows of minicpm3-4b's latent slab width (62 x 288)
SHAPES = [(16, 256), (4, 8, 128), (32, 130), (3, 5, 96), (16, 1000), (3, 17856)]


def _inputs(shape, dtype):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32) * 4
    tdt, jdt = DTYPES[dtype]
    return torch_from(x, tdt), jnp.asarray(x, jdt)


def _assert_q_within_reference_tolerance(q, want):
    """tests/test_kernels.py:27-28: within one step, under 1 % differing."""
    diff = np.abs(np.asarray(q, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_matches_reference_kernel_oracle_and_host_codec(shape, dtype):
    tx, jx = _inputs(shape, dtype)
    q, s = quantize(tx)
    assert q.shape == tx.shape and q.dtype == torch.int8
    assert s.shape == (shape[-1],) and s.dtype == torch.float32
    for jq, js in (jax_quantize(jx, interpret=True), jax_quantize_ref(jx)):
        _assert_q_within_reference_tolerance(q.numpy(), jq)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    # the host codec does the same f32 operations (IEEE division, rounding
    # half to even): bit for bit
    hq, hs = host_quantize(np.asarray(jx))
    np.testing.assert_array_equal(q.numpy(), hq)
    np.testing.assert_array_equal(s.numpy(), hs)


@pytest.mark.parametrize("out", list(DTYPES))
@pytest.mark.parametrize("shape", [(16, 256), (3, 5, 96), (32, 130)])
def test_dequantize_matches_reference_kernel_and_oracle(shape, out):
    tx, jx = _inputs(shape, "bf16")
    q, s = quantize(tx)
    jq, js = jax_quantize_ref(jx)
    tdt, jdt = DTYPES[out]
    d = dequantize(q, s, out_dtype=tdt)
    assert d.shape == tx.shape and d.dtype == tdt
    atol = float(np.max(np.asarray(js))) + 1e-3  # tests/test_kernels.py:44: one step of q
    for want in (jax_dequantize(jq, js, out_dtype=jdt, interpret=True), jax_dequantize_ref(jq, js, jdt)):
        np.testing.assert_allclose(d.float().numpy(), np.asarray(want, np.float32), atol=atol)
    # from the same q, the plain version and the host codec agree exactly
    host = host_dequantize(q.numpy(), s.numpy(), np.float32)
    np.testing.assert_array_equal(dequantize(q, s, out_dtype=torch.float32).numpy(), host)
    same = jax_dequantize_ref(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()), jdt)
    np.testing.assert_array_equal(d.float().numpy(), np.asarray(same, np.float32))


def test_round_trip_error_is_at_most_half_a_step():
    tx, _ = _inputs((64, 384), "f32")
    q, s = quantize(tx)
    err = (dequantize(q, s, out_dtype=torch.float32) - tx).abs()
    assert bool((err <= s / 2 + 1e-6).all())


def test_zero_channel_has_scale_one():
    x = np.random.default_rng(0).standard_normal((8, 256)).astype(np.float32)
    x[:, 5] = 0.0
    x[:, 200] = -0.0
    q, s = quantize(torch_from(x))
    jq, js = jax_quantize(jnp.asarray(x), interpret=True)
    assert s[5] == 1.0 and s[200] == 1.0
    assert not q[:, 5].any() and not q[:, 200].any()
    # XLA may turn the division by 127 into a product with its reciprocal, so
    # the reference kernel's scale can sit one f32 ulp off numpy's: its own
    # tolerance (tests/test_kernels.py:27-30); the host codec's exactly
    _assert_q_within_reference_tolerance(q.numpy(), jq)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    hq, hs = host_quantize(x)
    np.testing.assert_array_equal(q.numpy(), hq)
    np.testing.assert_array_equal(s.numpy(), hs)
    q0, s0 = quantize(torch.zeros(8, 128))
    np.testing.assert_array_equal(s0.numpy(), np.ones(128, np.float32))
    assert not q0.any()


def test_half_steps_round_to_even():
    """Channel 0 has absmax 127, so its scale is exactly 1.0 and x/scale
    sits exactly on the half steps: they round to the even neighbour, as
    numpy's and JAX's round do (not away from zero)."""
    col = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 3.5], np.float32)
    x = np.stack([col, col * 0.5], axis=1)
    q, s = quantize(torch_from(x))
    assert float(s[0]) == 1.0
    np.testing.assert_array_equal(q[:, 0].numpy(), [127, 0, 2, 2, 0, -2, -2, 126, -126, 4])
    jq, js = jax_quantize(jnp.asarray(x), interpret=True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(q.numpy(), host_quantize(x)[0])


def test_plain_version_is_what_the_cpu_runs():
    tx, _ = _inputs((4, 8, 128), "bf16")
    reset_launch_counts()
    q, s = quantize(tx)
    d = dequantize(q, s)
    qr, sr = quantize_ref(tx)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert torch.equal(d, dequantize_ref(qr, sr)) and d.dtype == torch.bfloat16
    counts = launch_counts()
    assert counts["quantize"] == 0 and counts["dequantize"] == 0  # CPU tensors launch nothing


def test_other_devices_and_dtypes_raise():
    with pytest.raises(ValueError, match="cuda .* or cpu"):
        quantize(torch.empty(4, 8, device="meta"))
    with pytest.raises(ValueError, match="cuda .* or cpu"):
        dequantize(torch.empty(4, 8, dtype=torch.int8, device="meta"), torch.empty(8, device="meta"))
    with pytest.raises(TypeError):
        quantize(torch.zeros(4, 8, dtype=torch.int32))
    with pytest.raises(TypeError):
        dequantize(torch.zeros(4, 8), torch.ones(8))
    with pytest.raises(TypeError):
        dequantize(torch.zeros(4, 8, dtype=torch.int8), torch.ones(8), out_dtype=torch.int32)
    with pytest.raises(ValueError, match="one value per channel"):
        dequantize(torch.zeros(4, 8, dtype=torch.int8), torch.ones(7))
    with pytest.raises(ValueError, match="non-empty"):
        quantize(torch.zeros(0, 8))
