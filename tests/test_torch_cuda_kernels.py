"""The port's CUDA kernels against their plain versions on the card.  Needs
a CUDA device and nvcc; each test skips without them (decided inside the
test, not at import).  On the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py

Imports no JAX: the machine with the card has none."""

import pytest
import torch

from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.decode_attention import paged_decode, paged_decode_ref
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

# (atol, rtol).  bf16: kernel and plain version both round an f32 result to
# bf16, so they differ by at most one bf16 step (2^-7 of the value); two are
# allowed, and the atol covers outputs near zero.  f32: summation order.
TOL = {torch.bfloat16: (1e-4, 2.0**-6), torch.float32: (1e-4, 1e-4)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; chip_smoke.py covers the same checks)")
    return torch.device("cuda")


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Sq,Skv,H,KVH,D,causal", [
    (1, 128, 128, 40, 8, 128, True),   # serve path, G = 5
    (2, 37, 100, 8, 2, 64, True),      # q_offset 63, ragged tiles
    (1, 1, 70, 4, 4, 32, True),        # one query
    (2, 64, 192, 8, 8, 128, False),    # non-causal, Skv a block multiple
])
def test_flash_kernel_matches_plain(dev, dtype, B, Sq, Skv, H, KVH, D, causal):
    g = torch.Generator(device=dev).manual_seed(Sq + Skv)
    q = _randn(g, (B, Sq, H, D), dtype, dev)
    k, v = _randn(g, (B, Skv, KVH, D), dtype, dev), _randn(g, (B, Skv, KVH, D), dtype, dev)
    off = Skv - Sq if causal else 0
    reset_launch_counts()
    out = flash_attention(q, k, v, causal=causal, q_offset=off, block_k=64)
    torch.cuda.synchronize()
    assert launch_counts()["flash"] == 1 and out.dtype == dtype
    ref = flash_attention_plain(q, k, v, causal, off)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


def test_flash_kernel_reads_a_strided_cache_slice(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    ck, cv = (_randn(g, (2, 144, 8, 128), torch.bfloat16, dev) for _ in range(2))
    q = _randn(g, (2, 40, 40, 128), torch.bfloat16, dev)
    out = flash_attention(q, ck[:, :104], cv[:, :104], causal=True, q_offset=64)
    ref = flash_attention_plain(q, ck[:, :104], cv[:, :104], True, 64)
    atol, rtol = TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,KVH,D,page,NB", [(1, 40, 8, 128, 16, 9), (4, 8, 2, 64, 8, 12), (3, 4, 4, 32, 32, 3)])
def test_paged_decode_kernel_matches_plain(dev, dtype, B, H, KVH, D, page, NB):
    g = torch.Generator(device=dev).manual_seed(B * 100 + D)
    P = B * NB + 3
    q = _randn(g, (B, H, D), dtype, dev)
    kp, vp = _randn(g, (P, page, KVH, D), dtype, dev), _randn(g, (P, page, KVH, D), dtype, dev)
    tables = torch.randperm(P, generator=g, device=dev)[:B * NB].to(torch.int32).view(B, NB).contiguous()
    lens = torch.randint(1, NB * page + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    lens[0] = 0 if B > 1 else lens[0]
    reset_launch_counts()
    out = paged_decode(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    assert launch_counts()["paged_decode"] == 1 and out.dtype == dtype
    ref = paged_decode_ref(q, kp, vp, tables, lens)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    if B > 1:
        assert out[0].abs().max().item() == 0.0  # kv_len = 0 gives zeros


def test_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros(1, 8, 4, 48, dtype=torch.bfloat16, device=dev)  # head dim 48 has no kernel
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, q[:, :, :2], q[:, :, :2])
    kp = torch.zeros(5, 16, 2, 128, dtype=torch.bfloat16, device=dev)
    tables = torch.zeros(1, 2, dtype=torch.int32, device=dev)
    lens = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        paged_decode(torch.zeros(1, 4, 256, dtype=torch.bfloat16, device=dev)[:, :, ::2], kp, kp, tables, lens)
