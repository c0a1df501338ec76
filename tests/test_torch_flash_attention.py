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
from repro.models.layers import sdpa as jax_sdpa
from repro_torch.kernels.flash_attention import (attention_ref, flash_attention, flash_attention_full,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_attention.ref import flash_tiles_plain


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


@pytest.mark.parametrize("Sq", [1500, 128])
def test_flash_full_matches_reference_sdpa_over_ragged_keys(Sq):
    """The full entry point over whisper's 1500 encoder frames (no multiple
    of any key block): the encoder's 1500 x 1500 and prefill
    cross-attention's 128 x 1500, against the reference's ``sdpa`` with
    causal=False (its chunked branch: keys padded to 2048, masked by
    kv_len), f32.  The wrapper with the reference kernel's contract still
    refuses the same call."""
    B, Skv, H, KVH, D = 1, 1500, 4, 2, 64
    qn, kn, vn = _inputs(Sq + Skv, B, Sq, Skv, H, KVH, D)
    got = flash_attention_full(torch_from(qn), torch_from(kn), torch_from(vn))
    q_pos = jnp.broadcast_to(jnp.arange(Sq, dtype=jnp.int32)[None], (B, Sq))
    want = jax_sdpa(jax_from(qn), jax_from(kn), jax_from(vn), q_pos, jnp.full((B,), Skv, jnp.int32), causal=False)
    assert got.shape == (B, Sq, H, D)
    np.testing.assert_allclose(np32(got), np32(want), rtol=F32_TOL, atol=F32_TOL)
    with pytest.raises(ValueError, match="non-causal"):
        flash_attention(torch_from(qn), torch_from(kn), torch_from(vn), causal=False)


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



@pytest.mark.parametrize("empty", ["kv_heads", "query_groups"])
def test_flash_wrappers_take_an_empty_part_of_a_head_split(empty):
    """A rank's empty part of a ``model`` split (no KV heads, or no query
    groups of its KV heads) gives an empty output through both wrappers;
    no KV heads beside some heads still raises."""
    rng = np.random.default_rng(5)
    q = torch_from(rng.standard_normal((2, 8, 4, 2, 16)), torch.float32)  # (B, S, KVH, G, D)
    k = torch_from(rng.standard_normal((2, 8, 4, 16)), torch.float32)
    q, k = (q[:, :, 4:], k[:, :, 4:]) if empty == "kv_heads" else (q[:, :, :, 2:], k)
    q = q.flatten(2, 3)
    for out in (flash_attention(q, k, k, causal=True, q_offset=3), flash_attention_full(q, k, k)):
        assert out.shape == (2, 8, 0, 16) and out.dtype == torch.float32
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(2, 8, 2, 16), k[:, :, :0], k[:, :, :0])

# The bf16 kernel's arithmetic (flash_tiles_plain: 64-key tiles, P split
# into bf16 hi + lo for the tensor-core P·V) against the plain version, at
# the limit the card holds the kernel to: |err| <= 1e-4 + 2^-6 |ref|.
CHIP_ATOL, CHIP_RTOL = 1e-4, 2.0**-6


def _share_of_chip_limit(out, ref):
    d, r = np.abs(np32(out) - np32(ref)), np.abs(np32(ref))
    return float((d / (CHIP_ATOL + CHIP_RTOL * r)).max())


def _bf16_inputs(seed, B, S, H, KVH, D, Dv):
    rng = np.random.default_rng(seed)
    return (torch_from(rng.standard_normal((B, S, H, D)), torch.bfloat16),
            torch_from(rng.standard_normal((B, S, KVH, D)), torch.bfloat16),
            torch_from(rng.standard_normal((B, S, KVH, Dv)), torch.bfloat16))


@pytest.mark.parametrize("B,S,H,KVH,D,Dv", [
    (1, 128, 40, 8, 128, 128),   # the serve path: qwen3-14b's 128-token prefill
    (1, 128, 40, 40, 96, 64),    # minicpm3-4b's MLA prefill
])
def test_flash_tiles_plain_within_the_chip_limit(B, S, H, KVH, D, Dv):
    q, k, v = _bf16_inputs(S + D, B, S, H, KVH, D, Dv)
    share = _share_of_chip_limit(flash_tiles_plain(q, k, v), flash_attention_plain(q, k, v, True, 0))
    assert share <= 0.75, share  # measured 0.48: room for another summation order, none for a bf16 P


def test_p_rounded_to_bf16_alone_breaks_the_chip_limit():
    """Why the kernel splits P: the same tile loop with P rounded to bf16
    (a tensor-core flash kernel's usual P·V) is several times over the limit
    where outputs cancel to near zero."""
    q, k, v = _bf16_inputs(128 + 128, 1, 128, 40, 8, 128, 128)
    share = _share_of_chip_limit(flash_tiles_plain(q, k, v, split_p=False), flash_attention_plain(q, k, v, True, 0))
    assert share > 4.0, share


@pytest.mark.parametrize("causal,off", [(True, 0), (True, 21), (False, 0)])
def test_flash_tiles_plain_matches_reference_kernel_bf16(causal, off):
    """Against the reference's Pallas kernel in interpret mode (f32 P) on the
    same bf16 inputs, at the chip limit; 2 key tiles of 64 and a ragged one."""
    rng = np.random.default_rng(17 + off)
    Sq, Skv = (43, 64 + off) if causal else (32, 128)
    qn, kn, vn = (rng.standard_normal(s) for s in [(2, Sq, 8, 32), (2, Skv, 2, 32), (2, Skv, 2, 32)])
    got = flash_tiles_plain(*(torch_from(a, torch.bfloat16) for a in (qn, kn, vn)), causal=causal, q_offset=off)
    want = jax_flash(*(jax_from(a, jnp.bfloat16) for a in (qn, kn, vn)), causal=causal, q_offset=off,
                     block_q=16, block_k=32 if causal else 64, interpret=True)
    assert _share_of_chip_limit(got, want) <= 1.0
