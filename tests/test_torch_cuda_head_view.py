"""The paged decode kernel over a rank's KV-head view of the cache, on the
card.  Needs a CUDA device and nvcc; each test skips without them (decided
inside the test, not at import).  On the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_head_view.py

Under a split over ``model`` a rank's pages are a strided view of the whole
cache (``models/layers.kv_head_view``); the kernel reads them in place at
their page and slot strides.  It gathers the same 16-byte rows as it would
from the view's contiguous copy and sums them in the same order, so the two
results are equal bit for bit.  Imports no JAX: the machine with the card
has none."""

import pytest
import torch

from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.decode_attention import HEAD_DIMS, paged_decode, paged_decode_ref
from repro_torch.models import layers
from repro_torch.models.layers import PAGE

# tests/test_torch_cuda_kernels.py's tolerances against the plain version,
# (atol, rtol): bf16 within about one bf16 step of the output (two
# allowed), f32 summation order
TOL = {torch.bfloat16: (1e-4, 2.0**-6), torch.float32: (1e-4, 1e-4)}
# (KVH, G, model, rank): qwen3-14b's split over KV heads at model 2 (4 of
# 8 KV heads, G 5; rank 1's view starts 4 heads in), and a wider one (KVH
# 3, G 1 at model 4: one KV head a rank, the last rank none)
VIEWS = [(8, 5, 2, 0), (8, 5, 2, 1), (3, 1, 4, 2), (3, 1, 4, 3)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; chip_smoke.py covers the same checks)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("KVH,G,model,rank", VIEWS, ids=[f"kvh{k}_g{g}_model{m}_rank{r}" for k, g, m, r in VIEWS])
def test_kernel_on_a_head_view_equals_it_on_the_copy(dev, dtype, D, KVH, G, model, rank):
    """A rank's view of (B, S, KVH, D) k and v caches as pages, over
    shuffled tables, kv_len up to 1024 (several splits), a kv_len = 0 row:
    the kernel gives its result on the view's contiguous copy bit for bit,
    and the plain version's within TOL."""
    from types import SimpleNamespace

    B, S = 3, 1024
    g = torch.Generator(device=dev).manual_seed(KVH * 1000 + D)
    k = torch.randn((B, S, KVH, D), generator=g, device=dev).to(dtype)
    v = torch.randn((B, S, KVH, D), generator=g, device=dev).to(dtype)
    cfg = SimpleNamespace(n_heads=KVH * G, n_kv_heads=KVH)
    kv, gs = layers.gqa_heads(cfg, SimpleNamespace(model_size=model, model_rank=rank))
    H = (kv[1] - kv[0]) * (gs[1] - gs[0])
    q = torch.randn((B, H, D), generator=g, device=dev).to(dtype)
    NB = S // PAGE
    kp = layers.kv_head_view(k, kv).view(B * NB, PAGE, kv[1] - kv[0], D)
    vp = layers.kv_head_view(v, kv).view(B * NB, PAGE, kv[1] - kv[0], D)
    assert H == 0 or not kp.is_contiguous()
    tables = torch.randperm(B * NB, generator=g, device=dev).to(torch.int32).view(B, NB).contiguous()
    lens = torch.tensor([0, S, 700], dtype=torch.int32, device=dev)
    reset_launch_counts()
    out = paged_decode(q, kp, vp, tables, lens)
    copy = paged_decode(q, kp.contiguous(), vp.contiguous(), tables, lens)
    torch.cuda.synchronize()
    assert launch_counts()["paged_decode"] == (2 if H else 0)
    assert torch.equal(out, copy)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), paged_decode_ref(q, kp, vp, tables, lens).float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_kernel_refuses_k_and_v_at_other_strides(dev, dtype):
    """k a rank's strided head view, v a contiguous tensor: the kernel
    reads k and v at one pair of strides, so the wrapper raises before any
    launch rather than read v wrong or copy either."""
    B, S, KVH, D, lo, hi = 2, 512, 8, 128, 4, 8
    g = torch.Generator(device=dev).manual_seed(11)
    k = torch.randn((B, S, KVH, D), generator=g, device=dev).to(dtype)
    NB = S // PAGE
    kp = k[:, :, lo:hi].view(B * NB, PAGE, hi - lo, D)
    vp = torch.randn((B * NB, PAGE, hi - lo, D), generator=g, device=dev).to(dtype)
    q = torch.randn((B, (hi - lo) * 5, D), generator=g, device=dev).to(dtype)
    tables = torch.randperm(B * NB, generator=g, device=dev).to(torch.int32).view(B, NB).contiguous()
    lens = torch.tensor([S, 300], dtype=torch.int32, device=dev)
    reset_launch_counts()
    with pytest.raises(ValueError, match="share their page and slot strides"):
        paged_decode(q, kp, vp, tables, lens)
    assert launch_counts()["paged_decode"] == 0
