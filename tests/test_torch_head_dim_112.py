"""Head dim 112 (kimi-k2's 7168 / 64 heads) in the port's two attention
kernels, on the CPU: the plain flash attention and the plain paged decode
(what each wrapper runs for CPU tensors, and what the card's kernels are
held to) against the reference's Pallas kernels in interpret mode, in f32
and bf16, on numpy inputs from a seed; and the bf16 flash kernel's tile
arithmetic at kimi-k2's serve shape within the card's limit.  The kernels
themselves run on the card (tests/test_torch_cuda_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from parity_harness import BF16_TOL, F32_TOL, jax_from, np32, torch_from

from repro.kernels.decode_attention import paged_decode as jax_paged_decode
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels.decode_attention import paged_decode
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.flash_attention.ref import flash_tiles_plain

D = 112
DTYPES = {"float32": (torch.float32, jnp.float32, F32_TOL), "bfloat16": (torch.bfloat16, jnp.bfloat16, BF16_TOL)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,Sq,Skv,H,KVH,block", [
    (1, 48, 48, 8, 1, 16),    # kimi-k2's G 8 (64 heads over 8 KV heads), a 48-token prefill
    (2, 21, 53, 4, 2, 16),    # q_offset 32, ragged query and key blocks
])
def test_flash_at_head_dim_112_matches_reference_kernel(dtype, B, Sq, Skv, H, KVH, block):
    tdtype, jdtype, tol = DTYPES[dtype]
    rng = np.random.default_rng(Sq * 100 + Skv)
    qn, kn, vn = (rng.standard_normal(s) for s in [(B, Sq, H, D), (B, Skv, KVH, D), (B, Skv, KVH, D)])
    off = Skv - Sq
    got = flash_attention(*(torch_from(a, tdtype) for a in (qn, kn, vn)), causal=True, q_offset=off,
                          block_q=block, block_k=block)
    want = jax_flash(*(jax_from(a, jdtype) for a in (qn, kn, vn)), causal=True, q_offset=off,
                     block_q=block, block_k=block, interpret=True)
    assert got.dtype == tdtype and got.shape == (B, Sq, H, D)
    np.testing.assert_allclose(np32(got), np32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,KVH,page,NB,P", [
    (2, 16, 2, 16, 3, 8),     # G 8 as kimi-k2's decode, 16-slot pages as the models' cache
    (3, 8, 8, 8, 4, 14),      # G 1, ragged kv_len over shuffled pages
])
def test_paged_decode_at_head_dim_112_matches_reference_kernel(dtype, B, H, KVH, page, NB, P):
    tdtype, jdtype, tol = DTYPES[dtype]
    rng = np.random.default_rng(B * 1000 + H)
    q = rng.standard_normal((B, H, D))
    kp, vp = rng.standard_normal((P, page, KVH, D)), rng.standard_normal((P, page, KVH, D))
    tables = rng.permutation(P)[:B * NB].reshape(B, NB).astype(np.int32)
    lens = rng.integers(1, NB * page + 1, (B,)).astype(np.int32)
    got = paged_decode(torch_from(q, tdtype), torch_from(kp, tdtype), torch_from(vp, tdtype),
                       torch.from_numpy(tables), torch.from_numpy(lens))
    want = jax_paged_decode(jax_from(q, jdtype), jax_from(kp, jdtype), jax_from(vp, jdtype),
                            jnp.asarray(tables), jnp.asarray(lens), interpret=True)
    assert got.dtype == tdtype and got.shape == (B, H, D)
    np.testing.assert_allclose(np32(got), np32(want), rtol=tol, atol=tol)


def test_flash_tiles_at_kimi_serve_shape_within_the_chip_limit():
    """The bf16 kernel's arithmetic (64-key tiles, P split into bf16 hi and
    lo) at kimi-k2's 128-token prefill, H 64, KVH 8, D 112, against the
    plain version at the limit the card holds the kernel to, |err| <= 1e-4
    + 2^-6 |ref|.  The padded V columns past 112 add nothing to the 112
    output columns, so the D 112 instance is this same arithmetic."""
    rng = np.random.default_rng(112)
    q, k, v = (torch_from(rng.standard_normal(s), torch.bfloat16)
               for s in [(1, 128, 64, D), (1, 128, 8, D), (1, 128, 8, D)])
    out, ref = flash_tiles_plain(q, k, v), flash_attention_plain(q, k, v, True, 0)
    share = float(((out.float() - ref.float()).abs() / (1e-4 + 2.0**-6 * ref.float().abs())).max())
    assert share <= 0.75, share  # as at the serve shape (tests/test_torch_flash_attention.py)
