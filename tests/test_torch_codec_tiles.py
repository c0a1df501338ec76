"""The codec kernels' decomposition and launch plans, as plain torch on the
CPU, against the JAX reference on the same numpy inputs; and the kernel
ops' refusal to cut autograd on CUDA.

``kv_codec/ref.py::quantize_slabs_plain`` is the split-T path's arithmetic:
a partial absmax per slab of rows, the max over the slabs, the quantize.
A max does not depend on its order, so it is held bit for bit against the
one-pass plain version, the JAX ``quantize_ref`` and the host codec
``core/codec.py::quantize_int8``.  The reference's Pallas kernel (interpret
mode) may take its scale one f32 ulp off (XLA turns the division by 127
into a product with its reciprocal), so against it the reference kernel
test's own tolerance holds (tests/test_kernels.py:27-30).

``quantize_plan`` / ``dequantize_plan`` are held to what the kernels'
index arithmetic (``csrc/kv_codec.cu``) needs: every row and channel
covered exactly once, 16-byte vectors only where aligned, one pass at the
serve block and split-T at 4096 x 8192.  The kernels themselves are held
against the plain versions on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from parity_harness import torch_from

from repro.core.codec import quantize_int8 as host_quantize
from repro.kernels.kv_codec import quantize as jax_quantize
from repro.kernels.kv_codec import quantize_ref as jax_quantize_ref
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import paged_decode
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.kv_codec import (
    dequantize,
    dequantize_plan,
    quantize,
    quantize_plan,
    quantize_ref,
    quantize_slabs_plain,
    vector_aligned,
)
from repro_torch.kernels.kv_codec import ops as codec_ops
from repro_torch.kernels.mamba2 import ssd
from repro_torch.kernels.rwkv6 import wkv

DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32),
          "f16": (torch.float16, jnp.float16)}
H100_SMS = 132


@functools.lru_cache(maxsize=None)
def _case(shape, dtype):
    """(torch x, JAX scale and q of quantize_ref, of the Pallas kernel in
    interpret mode, host codec q and scale) on one seeded numpy input."""
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32) * 4
    x[..., 3] = 0.0  # an all-zero channel: scale 1.0
    tdt, jdt = DTYPES[dtype]
    jx = jnp.asarray(x, jdt)
    return torch_from(x, tdt), jax_quantize_ref(jx), jax_quantize(jx, interpret=True), host_quantize(np.asarray(jx))


@pytest.mark.parametrize("slab", [1, 7, 16, 64, "T"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [
    (1, 300),       # T = 1
    (3, 5, 96),     # leading axes, T = 15: slabs of 7 leave a last slab of 1
    (100, 130),     # ragged last slabs (100 = 14·7 + 2 = 6·16 + 4 = 64 + 36)
    (200, 256),
])
def test_quantize_slabs_plain_is_bit_for_bit_the_codec(shape, dtype, slab):
    tx, (jq, js), (kq, ks), (hq, hs) = _case(shape, dtype)
    T = int(np.prod(shape[:-1]))
    q, s = quantize_slabs_plain(tx, T if slab == "T" else slab)
    qr, sr = quantize_ref(tx)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(q.numpy(), hq)
    np.testing.assert_array_equal(s.numpy(), hs)
    assert float(s[3]) == 1.0 and not q[..., 3].any()
    # the Pallas kernel: the reference kernel test's tolerance
    np.testing.assert_allclose(s.numpy(), np.asarray(ks), rtol=1e-6)
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(kq, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def _channels_covered(C, vec, tx, tiles):
    """How often the lanes of ``tiles`` blocks of ``tx`` lanes cover each
    channel: lane i of block b starts at (b·tx + i)·vec, runs where < C,
    and covers vec channels (kv_codec.cu)."""
    starts = (np.arange(tiles)[:, None] * tx + np.arange(tx)[None, :]).ravel() * vec
    starts = starts[starts < C]
    return np.bincount((starts[:, None] + np.arange(vec)[None, :]).ravel(), minlength=C)


def _quantize_rows_covered(plan, T):
    """Rows each lane row takes, as the kernels' loops walk them."""
    count = np.zeros(T, np.int64)
    if plan.path == "one_pass":  # quantize_one_pass_kernel: rows y + i·ty, i < MAX_RPT
        for y in range(plan.ty):
            for i in range(codec_ops.ROWS_PER_THREAD):
                if y + i * plan.ty < T:
                    count[y + i * plan.ty] += 1
        return count
    for slab in range(plan.n_slabs):  # quantize_slab_kernel's loop
        r0 = slab * plan.slab_rows
        r1 = min(T, r0 + plan.slab_rows)
        for y in range(plan.ty):
            for r in range(r0 + y, r1, codec_ops.UNROLL * plan.ty):
                for u in range(codec_ops.UNROLL):
                    if r + u * plan.ty < r1:
                        count[r + u * plan.ty] += 1
    return count


@pytest.mark.parametrize("T,C,elem,aligned", [
    (16, 81920, 2, True),    # a qwen3-14b serve block, f16
    (16, 17856, 2, True),    # minicpm3-4b's latent slab, bf16
    (4096, 8192, 2, True),
    (4097, 1000, 2, True),   # split-T, a ragged last slab
    (1, 81920, 2, True),
    (64, 300, 4, True),      # the last one-pass T
    (65, 300, 4, True),      # the first split-T T
    (4096, 8191, 2, False),  # C not whole vectors: one element a lane
    (300, 130, 4, False),
    (15, 96, 4, True),
])
def test_quantize_plan_covers_every_row_and_channel_once(T, C, elem, aligned):
    plan = quantize_plan(T, C, elem, aligned, H100_SMS)
    assert plan.vec == (16 // elem if aligned else 1)
    assert 32 <= plan.tx * plan.ty <= codec_ops.THREADS
    assert (_channels_covered(C, plan.vec, plan.tx, plan.channel_tiles) == 1).all()
    assert (_quantize_rows_covered(plan, T) == 1).all()
    if plan.path == "one_pass":
        assert plan.n_slabs == 1 and plan.slab_rows == T
        assert -(-T // plan.ty) <= codec_ops.ROWS_PER_THREAD  # fits the lanes' registers
    else:
        assert (plan.n_slabs - 1) * plan.slab_rows < T <= plan.n_slabs * plan.slab_rows  # no empty slab
        assert plan.n_slabs <= codec_ops.MAX_SLABS


def test_quantize_plan_paths():
    serve = quantize_plan(16, 81920, 2, True, H100_SMS)
    slab = quantize_plan(16, 17856, 2, True, H100_SMS)
    large = quantize_plan(4096, 8192, 2, True, H100_SMS)
    assert serve.path == "one_pass" and serve.vec == 8 and serve.channel_tiles >= H100_SMS
    assert slab.path == "one_pass" and slab.vec == 8 and slab.channel_tiles >= H100_SMS
    assert large.path == "split_t" and large.vec == 8
    assert large.channel_tiles * large.n_slabs >= 2 * H100_SMS  # the grid fills the card over
    assert quantize_plan(64, 8192, 2, True, H100_SMS).path == "one_pass"
    assert quantize_plan(65, 8192, 2, True, H100_SMS).path == "split_t"
    assert quantize_plan(16, 300, 4, True, H100_SMS).vec == 4


@pytest.mark.parametrize("T,C,out_bytes,aligned", [
    (16, 81920, 2, True), (16, 17856, 2, True), (4096, 8192, 2, True), (4096, 8192, 4, True),
    (4097, 1000, 2, False), (1, 300, 4, False),
    (200000, 16, 2, True),  # thousands of rows a lane: the grid-stride loop
])
def test_dequantize_plan_covers_every_row_and_channel_once(T, C, out_bytes, aligned):
    plan = dequantize_plan(T, C, out_bytes, aligned, H100_SMS)
    assert plan.vec == (16 // out_bytes if aligned else 1)  # one 16-byte store of outputs a lane
    assert 32 <= plan.tx * plan.ty <= codec_ops.THREADS and 1 <= plan.row_blocks <= 65535
    assert (_channels_covered(C, plan.vec, plan.tx, plan.channel_tiles) == 1).all()
    count = np.zeros(T, np.int64)  # dequantize_kernel's grid-stride loop
    step = plan.row_blocks * plan.ty
    starts = (np.arange(plan.row_blocks)[:, None] * plan.ty + np.arange(plan.ty)[None, :]).ravel()
    for r in starts[starts < T]:
        count[np.arange(r, T, step)] += 1
    assert (count == 1).all()


def test_vectors_only_where_aligned():
    x = torch.zeros(32, 256)
    assert vector_aligned(x, 4)
    assert vector_aligned(x[:, :200], 4)                        # row stride 256, C 200: whole vectors
    assert not vector_aligned(x[:, 1:201], 4)                   # starts 4 bytes off
    assert not vector_aligned(torch.zeros(8, 130), 4)           # C not whole vectors
    assert vector_aligned(torch.zeros(8, 300), 4)
    xb = torch.zeros(16, 264, dtype=torch.bfloat16)
    assert vector_aligned(xb, 8) and not vector_aligned(xb[:, 1:], 8)  # 2 bytes off
    assert not vector_aligned(torch.zeros(16, 264, dtype=torch.bfloat16)[:, :100], 8)
    assert vector_aligned(torch.zeros(4, 4096, dtype=torch.int8), 8)
    assert not vector_aligned(torch.zeros(4, 4100, dtype=torch.int8), 8)
    assert vector_aligned(torch.zeros(4, 4100, dtype=torch.int8), 4)


# ------------------------------------------------- autograd on the card
def _refuse():
    pytest.fail("the kernel was launched")


def test_run_on_refuses_an_input_that_requires_grad_on_cuda():
    cuda = torch.device("cuda")  # constructible without a card; nothing reaches it
    x = torch.zeros(4, requires_grad=True)
    with pytest.raises(RuntimeError, match="flash_attention.*plain_kernels=True"):
        _build.run_on("flash_attention", cuda, _refuse, _refuse, inputs=(torch.zeros(4), x))


def test_run_on_launches_without_grad():
    cuda = torch.device("cuda")
    x = torch.zeros(4, requires_grad=True)
    with torch.no_grad():
        assert _build.run_on("wkv", cuda, _refuse, lambda: "kernel", inputs=(x,)) == "kernel"
    with torch.inference_mode():
        assert _build.run_on("wkv", cuda, _refuse, lambda: "kernel", inputs=(x,)) == "kernel"
    assert _build.run_on("wkv", cuda, _refuse, lambda: "kernel", inputs=(torch.zeros(4), 3)) == "kernel"


def test_run_on_cpu_stays_differentiable():
    x = torch.ones(4, requires_grad=True)
    assert _build.run_on("ssd", torch.device("cpu"), lambda: "plain", _refuse, inputs=(x,)) == "plain"
    q = torch.randn(1, 5, 2, 32, requires_grad=True)
    k, v = torch.randn(1, 5, 2, 32), torch.randn(1, 5, 2, 32)
    flash_attention(q, k, v).sum().backward()
    assert q.grad is not None and bool(q.grad.abs().sum() > 0)


def _op_calls():
    """Each of the six kernel ops on small CPU inputs: (name, call(grad))
    where ``grad`` marks which input requires grad."""
    def flash(g):
        q = torch.randn(1, 4, 2, 32, requires_grad=g)
        return flash_attention(q, torch.randn(1, 4, 2, 32), torch.randn(1, 4, 2, 32))

    def decode(g):
        pages = torch.randn(3, 16, 2, 32, requires_grad=g)
        return paged_decode(torch.randn(1, 2, 32), pages, pages, torch.zeros(1, 2, dtype=torch.int32),
                            torch.ones(1, dtype=torch.int32))

    def scan_wkv(g):
        r = torch.randn(1, 2, 8, 16, requires_grad=g)
        return wkv(r, r, r, torch.full((1, 2, 8, 16), 0.9), torch.zeros(2, 16), torch.zeros(1, 2, 16, 16))

    def scan_ssd(g):
        x = torch.randn(1, 8, 2, 16, requires_grad=g)
        bc, ad = torch.randn(1, 8, 8), torch.rand(1, 8, 2)
        return ssd(x, bc, bc, ad, ad, torch.zeros(1, 2, 16, 8))

    def quant(g):
        return quantize(torch.randn(4, 32, requires_grad=g))

    def dequant(g):
        return dequantize(torch.zeros(4, 32, dtype=torch.int8), torch.ones(32, requires_grad=g))

    return [("flash_attention", flash), ("paged_decode", decode), ("wkv", scan_wkv), ("ssd", scan_ssd),
            ("quantize", quant), ("dequantize", dequant)]


@pytest.mark.parametrize("name,call", _op_calls(), ids=[n for n, _ in _op_calls()])
def test_every_kernel_op_hands_its_inputs_to_the_grad_guard(monkeypatch, name, call):
    """Each op gives ``run_on`` the inputs a caller could differentiate, so
    on CUDA the guard sees one that requires grad (here run_on is watched
    on CPU tensors, where the plain version then runs)."""
    seen = []
    real = _build.run_on

    def watch(what, device, plain, kernel, *, inputs):
        seen.append((what, any(getattr(t, "requires_grad", False) for t in inputs)))
        return real(what, device, plain, kernel, inputs=inputs)

    monkeypatch.setattr(_build, "run_on", watch)
    call(True)
    call(False)
    assert seen == [(name, True), (name, False)]
