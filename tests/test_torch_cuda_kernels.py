"""The port's CUDA kernels against their plain versions on the card.  Needs
a CUDA device and nvcc; each test skips without them (decided inside the
test, not at import).  On the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py

Imports no JAX: the machine with the card has none."""

import pytest
import torch

from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.decode_attention import paged_decode, paged_decode_ref
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_full, flash_attention_plain
from repro_torch.kernels.kv_codec import dequantize, dequantize_ref, plan_for_quantize, quantize, quantize_ref
from repro_torch.kernels.mamba2 import ssd, ssd_chunked, ssd_chunked_plain
from repro_torch.kernels.rwkv6 import wkv, wkv_chunked_plain, wkv_model

# (atol, rtol).  bf16: the plain version computes in f32 and rounds once to
# bf16.  The flash kernel's products run on tensor cores, with P·V split into
# bf16 P_hi and P_lo, which keeps P to ~2^-17 (a P rounded to bf16 alone
# would break the atol where outputs cancel to near zero); paged decode
# computes in f32.  So kernel and plain version differ by at most about one
# bf16 step of the output (2^-7 of the value); two are allowed, and the atol
# covers outputs near zero, where the kernels' f32 sums differ in order.
# f32: summation order.
TOL = {torch.bfloat16: (1e-4, 2.0**-6), torch.float32: (1e-4, 1e-4)}
# The scans: the reference kernel tests' own tolerances (tests/test_kernels.py:104,141).
# WKV sums on the FMA units in the plain version's order; SSD's products run
# on tensor cores with f32 operands in three bf16 pieces (~2^-24 of each
# product, mamba2/ref.py::ssd_tiles_plain), the sums in another order.
WKV_TOL, SSD_TOL = 3e-4, 4e-4


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
    (1, 1, 4096, 8, 2, 128, False),    # one query over 64 key tiles
    (1, 65, 4096, 8, 2, 128, True),    # q_offset 4031: a 128-row tile with 63 empty rows
    (1, 129, 4096, 8, 2, 128, False),  # two query tiles, the second with one row
    (2, 65, 4096, 16, 16, 64, True),   # D 64, G 1, q_offset 4031
    (1, 128, 128, 64, 8, 112, True),   # kimi-k2's serve prefill: D 112, a part-filled 64-column block
    (2, 37, 100, 8, 2, 112, True),     # D 112, q_offset 63, ragged tiles
    (2, 64, 192, 8, 8, 112, False),    # D 112, non-causal
    (1, 65, 4096, 64, 8, 112, True),   # D 112 over 64 key tiles, q_offset 4031
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Sq", [1500, 128])
def test_flash_full_kernel_over_ragged_keys(dev, dtype, Sq):
    """Whisper's non-causal shapes through the full entry point: the
    encoder's 1500 x 1500 (11 query tiles of 128 and one of 92) and prefill
    cross-attention's 128 x 1500, 12 heads of 64; the last key tile holds 28
    of 64 keys."""
    g = torch.Generator(device=dev).manual_seed(Sq)
    B, Skv, H, D = 1, 1500, 12, 64
    q = _randn(g, (B, Sq, H, D), dtype, dev)
    k, v = _randn(g, (B, Skv, H, D), dtype, dev), _randn(g, (B, Skv, H, D), dtype, dev)
    reset_launch_counts()
    out = flash_attention_full(q, k, v)
    torch.cuda.synchronize()
    assert launch_counts()["flash"] == 1 and out.dtype == dtype
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), flash_attention_plain(q, k, v, False, 0).float(), atol=atol, rtol=rtol)


def test_flash_kernel_reads_a_strided_cache_slice(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    ck, cv = (_randn(g, (2, 144, 8, 128), torch.bfloat16, dev) for _ in range(2))
    q = _randn(g, (2, 40, 40, 128), torch.bfloat16, dev)
    out = flash_attention(q, ck[:, :104], cv[:, :104], causal=True, q_offset=64)
    ref = flash_attention_plain(q, ck[:, :104], cv[:, :104], True, 64)
    atol, rtol = TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("empty", ["kv_heads", "query_groups"])
def test_attention_wrappers_launch_nothing_for_an_empty_part_of_a_head_split(dev, empty):
    """A rank's empty part of a ``model`` split (no heads) gives an empty
    output on the card without a launch, through the wrappers the models
    call (the model layer sends it nowhere else)."""
    g = torch.Generator(device=dev).manual_seed(7)
    q = _randn(g, (2, 16, 4, 2, 64), torch.bfloat16, dev)  # (B, S, KVH, G, D)
    k = _randn(g, (2, 16, 4, 64), torch.bfloat16, dev)
    q, k = (q[:, :, 4:], k[:, :, 4:]) if empty == "kv_heads" else (q[:, :, :, 2:], k)
    q = q.flatten(2, 3)
    tables = torch.arange(2, dtype=torch.int32, device=dev).view(2, 1)
    lens = torch.full((2,), 9, dtype=torch.int32, device=dev)
    reset_launch_counts()
    outs = (flash_attention(q, k, k, causal=True), flash_attention_full(q, k, k),
            paged_decode(q[:, 0], k, k, tables, lens))
    torch.cuda.synchronize()
    assert [tuple(o.shape) for o in outs] == [(2, 16, 0, 64), (2, 16, 0, 64), (2, 0, 64)]
    assert launch_counts()["flash"] == launch_counts()["paged_decode"] == 0

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,KVH,D,page,NB", [
    (1, 40, 8, 128, 16, 9), (4, 8, 2, 64, 8, 12), (3, 4, 4, 32, 32, 3),
    (2, 32, 1, 64, 16, 6),     # G 32: bf16 runs two groups of 16 query rows
    (3, 48, 2, 128, 16, 9),    # G 24: a full group and a group of 8
    (2, 32, 1, 64, 16, 64),    # G 32 over 32 splits of 32 slots
    (1, 64, 8, 112, 16, 9),    # kimi-k2's decode: D 112 (7 k-steps, 14 n-tiles; f32: 28 of 32 lanes)
    (3, 16, 2, 112, 16, 12),   # D 112 with a kv_len = 0 row
    (2, 64, 8, 112, 16, 256),  # D 112 over up to 4096 slots, several splits
])
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("page,NB,lens", [
    (64, 2, [100, 31]),         # splits of 32 slots end inside pages of 64
    (16, 9, [7, 32]),           # every split but the first empty, and one exactly full
    (16, 256, [4096, 0]),       # a 4096-token row over 8 splits beside a kv_len = 0 row
])
def test_paged_decode_kernel_across_splits(dev, dtype, page, NB, lens):
    from repro_torch.kernels.decode_attention import split_plan
    g = torch.Generator(device=dev).manual_seed(page + NB)
    B, H, KVH, D = len(lens), 40, 8, 128
    n_splits, split_len = split_plan(B, KVH, NB * page, torch.cuda.get_device_properties(dev).multi_processor_count)
    assert n_splits > 1
    P = B * NB + 1
    q = _randn(g, (B, H, D), dtype, dev)
    kp, vp = _randn(g, (P, page, KVH, D), dtype, dev), _randn(g, (P, page, KVH, D), dtype, dev)
    tables = torch.randperm(P, generator=g, device=dev)[:B * NB].to(torch.int32).view(B, NB).contiguous()
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    out = paged_decode(q, kp, vp, tables, kv_len)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), paged_decode_ref(q, kp, vp, tables, kv_len).float(), atol=atol, rtol=rtol)
    for i, n in enumerate(lens):
        if n == 0:
            assert out[i].abs().max().item() == 0.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_decode_kernel_over_the_cross_cache(dev, dtype):
    """Whisper's decode cross-attention: one query of 12 heads of 64 over
    the cross cache of 1500 encoder frames laid out as 94 pages of 16
    slots, the last 4 slots past kv_len (filled here, so an unmasked pad
    slot would show)."""
    g = torch.Generator(device=dev).manual_seed(1500)
    H, D, page, NB = 12, 64, 16, 94
    q = _randn(g, (1, H, D), dtype, dev)
    kp, vp = _randn(g, (NB, page, H, D), dtype, dev), _randn(g, (NB, page, H, D), dtype, dev)
    tables = torch.arange(NB, dtype=torch.int32, device=dev).view(1, NB)
    lens = torch.tensor([1500], dtype=torch.int32, device=dev)
    reset_launch_counts()
    out = paged_decode(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    assert launch_counts()["paged_decode"] == 1 and out.dtype == dtype
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), paged_decode_ref(q, kp, vp, tables, lens).float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Sq,Skv,H,off", [(1, 128, 128, 40, 0), (2, 37, 100, 8, 63), (1, 1, 70, 4, 69)])
def test_flash_kernel_with_v_head_dim_64_under_q_k_96(dev, dtype, B, Sq, Skv, H, off):
    """MLA's shapes: q/k head dim 96, v head dim 64, scale 96^-0.5."""
    g = torch.Generator(device=dev).manual_seed(Sq * 7 + Skv)
    q, k = _randn(g, (B, Sq, H, 96), dtype, dev), _randn(g, (B, Skv, H, 96), dtype, dev)
    v = _randn(g, (B, Skv, H, 64), dtype, dev)
    reset_launch_counts()
    out = flash_attention(q, k, v, causal=True, q_offset=off)
    torch.cuda.synchronize()
    assert launch_counts()["flash"] == 1 and out.shape == (B, Sq, H, 64) and out.dtype == dtype
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), flash_attention_plain(q, k, v, True, off).float(), atol=atol, rtol=rtol)


# the reference kernel test's tolerance (tests/test_kernels.py:27-30): q within
# one step with under 1 % of entries differing, scale rtol 1e-6.  Kernel and
# plain version do the same IEEE f32 division and round half to even, so
# they are expected to agree bit for bit.
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("shape", [(16, 81920), (16, 17856), (4, 8, 128), (3, 5, 96), (300, 130)])
def test_kv_codec_kernels_match_plain(dev, dtype, shape):
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    x = _randn(g, shape, torch.float32, dev).mul_(4).to(dtype)
    x[..., 3] = 0  # an all-zero channel: scale 1.0
    reset_launch_counts()
    q, s = quantize(x)
    torch.cuda.synchronize()
    assert launch_counts()["quantize"] == 1 and q.shape == x.shape and s.shape == (shape[-1],)
    qr, sr = quantize_ref(x)
    diff = (q.int() - qr.int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 0.01
    torch.testing.assert_close(s, sr, rtol=1e-6, atol=0)
    assert float(s[3]) == 1.0 and not q[..., 3].any()
    for out in (torch.bfloat16, torch.float32, torch.float16):
        d = dequantize(q, s, out_dtype=out)
        torch.cuda.synchronize()
        assert d.dtype == out and d.shape == x.shape
        torch.testing.assert_close(d.float(), dequantize_ref(q, s, out).float(), rtol=0, atol=0)
    assert launch_counts()["dequantize"] == 3


def test_kv_codec_reads_a_row_strided_view(dev):
    x = torch.randn(32, 256, device=dev)[:, :200]  # rows 256 apart, 200 channels
    q, s = quantize(x)
    qr, sr = quantize_ref(x)
    assert torch.equal(q, qr) and torch.equal(s, sr)


@pytest.mark.parametrize("dtype,shape,path", [
    (torch.bfloat16, (4096, 8192), "split_t"),
    (torch.float16, (4097, 1000), "split_t"),  # 26 slabs, the last of 97 rows
    (torch.bfloat16, (1, 81920), "one_pass"),
    (torch.float32, (1, 81920), "one_pass"),
    (torch.float32, (64, 300), "one_pass"),    # the last one-pass T
    (torch.float32, (65, 300), "split_t"),     # the first split-T T
])
def test_kv_codec_kernels_equal_plain_across_the_plans(dev, dtype, shape, path):
    """Bit for bit on both sides of the one-pass / split-T boundary: a max
    does not depend on its order, and both do the same IEEE f32 division."""
    g = torch.Generator(device=dev).manual_seed(shape[0])
    x = _randn(g, shape, torch.float32, dev).mul_(4).to(dtype)
    x[:, 5] = 0
    assert plan_for_quantize(x).path == path
    q, s = quantize(x)
    qr, sr = quantize_ref(x)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    for out in (torch.bfloat16, torch.float32, torch.float16):
        assert torch.equal(dequantize(q, s, out_dtype=out), dequantize_ref(q, s, out))


@pytest.mark.parametrize("cut", ["start", "channels"])
def test_kv_codec_unaligned_and_ragged_inputs(dev, cut):
    """x[:, 1:] in bf16 starts 2 bytes off 16: one element a lane.  C = 300
    f32 is 75 vectors of 4: a ragged last tile.  Codes 1 byte off 16: the
    dequantize instance of one element a lane."""
    g = torch.Generator(device=dev).manual_seed(9)
    if cut == "start":
        x = _randn(g, (48, 265), torch.bfloat16, dev)[:, 1:]
        assert x.data_ptr() % 16 == 2 and plan_for_quantize(x).vec == 1
    else:
        x = _randn(g, (100, 300), torch.float32, dev)
        assert plan_for_quantize(x).vec == 4
    q, s = quantize(x)
    qr, sr = quantize_ref(x)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert torch.equal(dequantize(q, s, out_dtype=torch.float32), dequantize_ref(q, s, torch.float32))
    q_off = torch.zeros(q.numel() + 1, dtype=torch.int8, device=dev)[1:].view(q.shape).copy_(q)  # 1 byte off
    assert torch.equal(dequantize(q_off, s, out_dtype=torch.bfloat16), dequantize_ref(q, s, torch.bfloat16))


def _grad_cases(dev):
    """Each kernel op on small card inputs: (name, call(grad)) where ``grad``
    marks the input that requires grad."""
    def rnd(*shape):
        return torch.randn(shape, device=dev)

    def flash(g):
        return flash_attention(rnd(1, 8, 2, 64).requires_grad_(g), rnd(1, 8, 2, 64), rnd(1, 8, 2, 64))

    def decode(g):
        tables = torch.zeros(1, 2, dtype=torch.int32, device=dev)
        lens = torch.ones(1, dtype=torch.int32, device=dev)
        return paged_decode(rnd(1, 2, 64).requires_grad_(g), rnd(3, 16, 2, 64), rnd(3, 16, 2, 64), tables, lens)

    def scan_wkv(g):
        r = rnd(1, 16, 2, 16)
        return wkv_model(r.requires_grad_(g), r, r, torch.full_like(r, 0.9), torch.zeros(2, 16, device=dev),
                         torch.zeros(1, 2, 16, 16, device=dev))

    def scan_ssd(g):
        x, bc, ad = rnd(1, 16, 2, 16), rnd(1, 16, 8), torch.rand(1, 16, 2, device=dev)
        return ssd_chunked(x.requires_grad_(g), bc, bc, ad, ad, torch.zeros(1, 2, 16, 8, device=dev))

    def quant(g):
        return quantize(rnd(16, 256).requires_grad_(g))

    def dequant(g):
        return dequantize(torch.ones(16, 256, dtype=torch.int8, device=dev), rnd(256).requires_grad_(g))

    return {"flash": flash, "paged_decode": decode, "wkv": scan_wkv, "ssd": scan_ssd, "quantize": quant,
            "dequantize": dequant}


@pytest.mark.parametrize("name", ["flash", "paged_decode", "wkv", "ssd", "quantize", "dequantize"])
def test_kernel_ops_raise_rather_than_cut_autograd(dev, name):
    """No kernel has a backward: under grad mode an input that requires
    grad raises and launches nothing; under inference_mode or no_grad the
    kernel runs."""
    call = _grad_cases(dev)[name]
    reset_launch_counts()
    with pytest.raises(RuntimeError, match="no backward.*plain_kernels=True"):
        call(True)
    assert launch_counts()[name] == 0
    with torch.inference_mode():
        call(True)
    with torch.no_grad():
        call(True)
    call(False)
    torch.cuda.synchronize()
    assert launch_counts()[name] == 3


def test_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros(1, 8, 4, 48, dtype=torch.bfloat16, device=dev)  # head dim 48 has no kernel
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, q[:, :, :2], q[:, :, :2])
    kp = torch.zeros(5, 16, 2, 128, dtype=torch.bfloat16, device=dev)
    tables = torch.zeros(1, 2, dtype=torch.int32, device=dev)
    lens = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        paged_decode(torch.zeros(1, 4, 256, dtype=torch.bfloat16, device=dev)[:, :, ::2], kp, kp, tables, lens)


def _wkv_inputs(g, B, S, H, N, dtype, dev):
    """Model layout, the model's decay (the chunk-16 clamp acts), a carried state."""
    r, k, v = (_randn(g, (B, S, H, N), dtype, dev) for _ in range(3))
    w = torch.exp(-torch.exp(_randn(g, (B, S, H, N), torch.float32, dev)))
    u, s0 = _randn(g, (H, N), torch.float32, dev) * 0.3, _randn(g, (B, H, N, N), torch.float32, dev) * 0.5
    return r, k, v, w, u, s0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,N,chunk", [
    (1, 128, 32, 64, 16), (2, 77, 4, 32, 16), (1, 40, 3, 16, 64),
    (1, 1, 4, 64, 16),       # one step
    (3, 1000, 2, 64, 16),    # 63 chunks: 16 state groups, B 3
    (1, 700, 2, 64, 32),     # chunk 32: 6 groups, the last of 2 chunks and ragged
    (1, 600, 2, 64, 64),     # chunk 64: 4 groups of up to 3 chunks
    (1, 300, 2, 8, 16),      # N under a slab's 16 columns
    (2, 200, 2, 24, 16),     # a full slab and a slab of 8
    (1, 150, 2, 4, 16),      # rows of 8 bytes: plain loads, not cp.async
    (1, 95, 2, 40, 7),       # chunk 7: rows padded to 8 in the records; slabs of 16, 16, 8
])
def test_wkv_kernel_matches_plain(dev, dtype, B, S, H, N, chunk):
    g = torch.Generator(device=dev).manual_seed(S + N)
    r, k, v, w, u, s0 = _wkv_inputs(g, B, S, H, N, dtype, dev)
    reset_launch_counts()
    y, s = wkv_model(r, k, v, w, u, s0, chunk=chunk)
    torch.cuda.synchronize()
    assert launch_counts()["wkv"] == 1 and y.dtype == torch.float32
    yp, sp = wkv_chunked_plain(r, k, v, w, u, s0, chunk)
    torch.testing.assert_close(y, yp, atol=WKV_TOL, rtol=WKV_TOL)
    torch.testing.assert_close(s, sp, atol=WKV_TOL, rtol=WKV_TOL)


def test_wkv_kernel_reads_the_op_layout(dev):
    """(B, H, S, N) at chunk 32, through strides."""
    g = torch.Generator(device=dev).manual_seed(5)
    r, k, v = (_randn(g, (2, 4, 100, 64), torch.float32, dev) for _ in range(3))
    w = 0.45 + 0.5 * torch.sigmoid(_randn(g, (2, 4, 100, 64), torch.float32, dev))
    u, s0 = _randn(g, (4, 64), torch.float32, dev) * 0.3, _randn(g, (2, 4, 64, 64), torch.float32, dev) * 0.5
    y, s = wkv(r, k, v, w, u, s0, chunk=32)
    yp, sp = wkv_chunked_plain(*(t.transpose(1, 2) for t in (r, k, v, w)), u, s0, 32)
    torch.testing.assert_close(y, yp.transpose(1, 2), atol=WKV_TOL, rtol=WKV_TOL)
    torch.testing.assert_close(s, sp, atol=WKV_TOL, rtol=WKV_TOL)


def _ssd_inputs(g, B, S, H, P, N, dtype, dev):
    x = _randn(g, (B, S, H, P), dtype, dev)
    Bm, Cm = _randn(g, (B, S, N), dtype, dev), _randn(g, (B, S, N), dtype, dev)
    dt = torch.nn.functional.softplus(_randn(g, (B, S, H), torch.float32, dev))
    a = torch.exp(-dt * torch.exp(_randn(g, (H,), torch.float32, dev) * 0.3))
    s0 = _randn(g, (B, H, P, N), torch.float32, dev) * 0.5
    return x, Bm, Cm, a, dt, s0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 128, 64, 64, 64, 256), (2, 333, 3, 32, 16, 256), (1, 100, 2, 64, 64, 64), (1, 50, 4, 8, 16, 16),
    (1, 1, 4, 64, 64, 256),     # one step
    (3, 40, 2, 64, 64, 256),    # S < 64, B 3
    (1, 1500, 2, 64, 64, 256),  # 6 chunks, the last ragged
    (2, 700, 3, 16, 8, 64),     # P and N under 16, 11 chunks
    (1, 600, 2, 5, 3, 100),     # odd P and N; chunks of two row tiles, 64 and 36
])
def test_ssd_kernel_matches_plain(dev, dtype, B, S, H, P, N, chunk):
    g = torch.Generator(device=dev).manual_seed(S + P)
    x, Bm, Cm, a, dt, s0 = _ssd_inputs(g, B, S, H, P, N, dtype, dev)
    reset_launch_counts()
    y, s = ssd_chunked(x, Bm, Cm, a, dt, s0, chunk=chunk)
    torch.cuda.synchronize()
    assert launch_counts()["ssd"] == 1 and y.dtype == torch.float32
    yp, sp = ssd_chunked_plain(x, Bm, Cm, a, dt, s0, chunk)
    torch.testing.assert_close(y, yp, atol=SSD_TOL, rtol=SSD_TOL)
    torch.testing.assert_close(s, sp, atol=SSD_TOL, rtol=SSD_TOL)


def test_ssd_kernel_reads_the_models_views_in_place(dev):
    """x, B and C as slices of one convolution output, as mamba2_mix hands them."""
    g = torch.Generator(device=dev).manual_seed(7)
    B, S, H, P, N = 1, 70, 4, 32, 16
    xc = _randn(g, (B, S, H * P + 2 * N), torch.bfloat16, dev)
    x, Bm, Cm = xc[..., :H * P].reshape(B, S, H, P), xc[..., H * P:H * P + N], xc[..., H * P + N:]
    dt = torch.nn.functional.softplus(_randn(g, (B, S, H), torch.float32, dev))
    a, s0 = torch.exp(-dt), torch.zeros(B, H, P, N, device=dev)
    y, s = ssd(x, Bm, Cm, a, dt, s0)
    yp, sp = ssd_chunked_plain(x, Bm, Cm, a, dt, s0, 64)
    torch.testing.assert_close(y, yp, atol=SSD_TOL, rtol=SSD_TOL)
    torch.testing.assert_close(s, sp, atol=SSD_TOL, rtol=SSD_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("scan", ["wkv", "ssd"])
def test_scan_kernels_chain_through_the_returned_state(dev, dtype, scan):
    """Two calls, the second starting from the first's state, against one
    call over both halves: WKV cut at a chunk boundary inside a state group
    (the clamp is per chunk), SSD inside a chunk."""
    g = torch.Generator(device=dev).manual_seed(11)
    if scan == "wkv":
        r, k, v, w, u, s0 = _wkv_inputs(g, 2, 400, 3, 64, dtype, dev)
        seq, cut, tol = (r, k, v, w), 160, WKV_TOL
        def run(seq, s):
            return wkv_model(*seq, u, s)
    else:
        *seq, s0 = _ssd_inputs(g, 2, 700, 3, 64, 64, dtype, dev)
        cut, tol = 300, SSD_TOL
        def run(seq, s):
            return ssd_chunked(*seq, s)
    y, s = run(seq, s0)
    y1, s1 = run([t[:, :cut] for t in seq], s0)
    y2, s2 = run([t[:, cut:] for t in seq], s1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, atol=tol, rtol=tol)
    torch.testing.assert_close(s2, s, atol=tol, rtol=tol)


def test_scan_kernels_refuse_what_they_do_not_take(dev):
    z = torch.zeros(1, 8, 2, 128, device=dev)  # head size 128 > 64
    with pytest.raises(ValueError, match="N <= 64"):
        wkv_model(z, z, z, z + 1, torch.zeros(2, 128, device=dev), torch.zeros(1, 2, 128, 128, device=dev))
    x = torch.zeros(1, 8, 2, 16, device=dev)
    bc, ad = torch.zeros(1, 8, 8, device=dev), torch.zeros(1, 8, 2, device=dev)
    with pytest.raises(ValueError, match="chunk <= 256"):
        ssd_chunked(x, bc, bc, ad + 1, ad, torch.zeros(1, 2, 16, 8, device=dev), chunk=512)
    with pytest.raises(ValueError, match="unit stride"):
        ssd(torch.zeros(1, 8, 2, 32, device=dev)[..., ::2], bc, bc, ad + 1, ad, torch.zeros(1, 2, 16, 8, device=dev))
