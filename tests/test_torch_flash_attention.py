"""The port's flash attention (plain version, which its wrapper runs for CPU
tensors) against the reference's Pallas kernel in interpret mode and its
``attention_ref`` oracle, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from parity_harness import BF16_TOL, F32_TOL, jax_from, np32, torch_from

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels.flash_attention import attention_ref, flash_attention


def _inputs(seed, B, Sq, Skv, H, KVH, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)), rng.standard_normal((B, Skv, KVH, D)),
            rng.standard_normal((B, Skv, KVH, D)))


# the reference kernel test's cases (tests/test_kernels.py:166-180), then
# G = 5 (qwen3-14b's 40/8), q_offset > 0 with ragged lengths, and Sq = 1
CASES = [
    (2, 128, 128, 4, 2, 64, 64),
    (2, 64, 192, 8, 8, 128, 64),
    (1, 24, 24, 10, 2, 32, 8),
    (2, 37, 77, 10, 2, 16, 16),
    (1, 1, 45, 10, 2, 16, 16),
]


@pytest.mark.parametrize("B,Sq,Skv,H,KVH,D,block", CASES)
def test_flash_matches_reference_kernel_f32(B, Sq, Skv, H, KVH, D, block):
    qn, kn, vn = _inputs(Sq * 1000 + Skv, B, Sq, Skv, H, KVH, D)
    off = Skv - Sq
    got = flash_attention(torch_from(qn), torch_from(kn), torch_from(vn), causal=True,
                          q_offset=off, block_q=block, block_k=block)
    want = jax_flash(jax_from(qn), jax_from(kn), jax_from(vn), causal=True, q_offset=off,
                     block_q=block, block_k=block, interpret=True)
    np.testing.assert_allclose(np32(got), np32(want), rtol=F32_TOL, atol=F32_TOL)
    oracle = jax_attention_ref(*(jnp.moveaxis(jax_from(a), 1, 2) for a in (qn, kn, vn)),
                               causal=True, q_offset=off)
    np.testing.assert_allclose(np32(got), np.moveaxis(np32(oracle), 1, 2), rtol=F32_TOL, atol=F32_TOL)


def test_flash_matches_reference_kernel_bf16():
    """bf16 in and out: both sides compute in f32 and round the result to
    bf16, so they may differ by one bf16 step (stated BF16_TOL)."""
    qn, kn, vn = _inputs(7, 2, 40, 40, 10, 2, 32)
    got = flash_attention(*(torch_from(a, torch.bfloat16) for a in (qn, kn, vn)), causal=True)
    want = jax_flash(*(jax_from(a, jnp.bfloat16) for a in (qn, kn, vn)), causal=True,
                     block_q=16, block_k=16, interpret=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(got), np32(want), rtol=BF16_TOL, atol=BF16_TOL)


def test_flash_non_causal_matches_and_raises_like_the_reference():
    qn, kn, vn = _inputs(3, 1, 16, 32, 4, 2, 16)
    got = flash_attention(torch_from(qn), torch_from(kn), torch_from(vn), causal=False, block_k=16)
    want = jax_flash(jax_from(qn), jax_from(kn), jax_from(vn), causal=False, block_q=16, block_k=16,
                     interpret=True)
    np.testing.assert_allclose(np32(got), np32(want), rtol=F32_TOL, atol=F32_TOL)
    # a non-causal call that would need key padding raises in both packages
    qn, kn, vn = _inputs(4, 1, 16, 20, 4, 2, 16)
    with pytest.raises(ValueError, match="non-causal"):
        flash_attention(torch_from(qn), torch_from(kn), torch_from(vn), causal=False, block_k=16)
    with pytest.raises(ValueError, match="non-causal"):
        jax_flash(jax_from(qn), jax_from(kn), jax_from(vn), causal=False, block_q=16, block_k=16,
                  interpret=True)


def test_attention_ref_matches_reference_oracle_kernel_layout():
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal(s) for s in [(2, 10, 9, 16), (2, 2, 21, 16), (2, 2, 21, 16)])
    got = attention_ref(torch_from(q), torch_from(k), torch_from(v), causal=True, q_offset=12)
    want = jax_attention_ref(jax_from(q), jax_from(k), jax_from(v), causal=True, q_offset=12)
    np.testing.assert_allclose(np32(got), np32(want), rtol=F32_TOL, atol=F32_TOL)


def test_flash_wrapper_checks_its_inputs():
    q, k = torch.zeros(1, 4, 4, 16), torch.zeros(1, 4, 2, 16)
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 4, 3, 16), torch.zeros(1, 4, 3, 16))  # 4 heads, 3 kv heads
    with pytest.raises(ValueError):
        flash_attention(q, k, k, q_offset=-1)
    with pytest.raises(ValueError):  # neither the card nor the CPU: no plain fallback
        flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))
