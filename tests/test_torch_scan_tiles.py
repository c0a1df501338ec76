"""The scan kernels' arithmetic, as plain torch on the CPU, against the JAX
reference on the same numpy inputs.

``mamba2/ref.py::ssd_tiles_plain`` is the SSD kernel's arithmetic: every
chunk's local state in parallel, the sequential state pass, 64-row output
tiles, and every product on bf16 tensor cores with f32 operands split into
three bf16 pieces.  ``rwkv6/ref.py::wkv_tiles_plain`` is the WKV kernel's:
16-column value slabs, state groups of chunks (local states, the pass,
each group's outputs from its start), f32 products on the FMA units.  Both are held against
``repro.models.ssm.mamba2_ssd_chunked`` / ``wkv_chunked`` and against the
Pallas kernels in interpret mode, as the reference's own tests run them.
The kernels themselves are held against the plain versions on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from parity_harness import jax_from, np32, torch_from

from repro.kernels.mamba2 import ssd as jax_ssd
from repro.kernels.rwkv6 import wkv as jax_wkv
from repro.models import ssm as jax_ssm
from repro_torch.kernels.mamba2.ref import ssd_chunked_plain, ssd_tiles_plain
from repro_torch.kernels.rwkv6.ref import wkv_chunked_plain, wkv_group_plan, wkv_tiles_plain

# The scans' tolerances, atol = rtol: the reference kernel tests' own
# (tests/test_kernels.py:104,141), which chip_smoke.py holds the kernels to.
SSD_TOL = 4e-4
WKV_TOL = 3e-4


def _share(got, want, tol):
    """Largest |got - want| / (tol + tol |want|) over the outputs: <= 1 passes."""
    return max(float(np.max(np.abs(np32(g) - np32(w)) / (tol + tol * np.abs(np32(w))))) for g, w in zip(got, want))


def _ssd_inputs(seed, B, S, H, P, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P))
    Bm, Cm = rng.standard_normal((B, S, N)), rng.standard_normal((B, S, N))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))
    a = np.exp(-dt * np.exp(rng.standard_normal((H,))[None, None] * 0.3))
    s0 = rng.standard_normal((B, H, P, N)) * 0.5
    return x, Bm, Cm, a, dt, s0


def _wkv_inputs(seed, B, S, H, N):
    """Model layout (B, S, H, N); w as the model draws it, exp(-exp(xw)),
    so the chunk-16 clamp acts in ~5 % of the entries."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, N)) for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, S, H, N))))
    u = rng.standard_normal((H, N)) * 0.3
    s0 = rng.standard_normal((B, H, N, N)) * 0.5
    return r, k, v, w, u, s0


def _both(arrays, bf16_first: int, dtype):
    """(torch, JAX) copies; the first ``bf16_first`` arrays in ``dtype``."""
    tt = [torch_from(a, torch.bfloat16 if i < bf16_first and dtype == "bf16" else torch.float32)
          for i, a in enumerate(arrays)]
    jj = [jax_from(a, jnp.bfloat16 if i < bf16_first and dtype == "bf16" else jnp.float32)
          for i, a in enumerate(arrays)]
    return tt, jj


# ------------------------------------------------------------------- SSD
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("B,S,H,P,N", [
    (2, 600, 2, 16, 8),    # three chunks of 256, the last ragged (88), B 2, P and N under 64
    (1, 128, 2, 64, 64),   # the zamba2 path's shape, two heads
    (1, 300, 3, 5, 3),     # odd P and N
])
def test_ssd_tiles_plain_matches_mamba2_ssd_chunked(dtype, B, S, H, P, N):
    """At the model's chunk of 256, a carried state."""
    tt, jj = _both(_ssd_inputs(S + P, B, S, H, P, N), 3, dtype)
    got = ssd_tiles_plain(*tt, chunk=256)
    want = jax_ssm.mamba2_ssd_chunked(*jj)
    assert got[0].shape == (B, S, H, P) and got[1].shape == (B, H, P, N)
    assert _share(got, want, SSD_TOL) <= 1.0


@pytest.mark.parametrize("chunk", [64, 100])
def test_ssd_tiles_plain_matches_the_pallas_kernel(chunk):
    """The reference op (its Pallas ssd_kernel, interpret mode) over three
    chunks and a ragged fourth; chunk 100 takes row tiles of 64 and 36."""
    tt, jj = _both(_ssd_inputs(chunk, 2, 3 * chunk + 17, 2, 32, 16), 0, "f32")
    got = ssd_tiles_plain(*tt, chunk=chunk)
    want = jax_ssd(*jj, chunk=chunk, interpret=True)
    assert _share(got, want, SSD_TOL) <= 1.0


# ------------------------------------------------------------------- WKV
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("B,S,H,N,group", [
    (2, 300, 2, 16, None),  # 19 chunks of 16: groups of 4, the last of 3 and ragged, B 2
    (1, 100, 2, 24, 2),     # two slabs (16 and 8 columns), groups of 2 chunks
    (1, 40, 3, 64, None),   # one group: no state pass
    (1, 9, 2, 64, None),    # one ragged chunk (S < chunk)
])
def test_wkv_tiles_plain_matches_wkv_chunked_at_the_clamp(dtype, B, S, H, N, group):
    ins = _wkv_inputs(S + N, B, S, H, N)
    assert (np.log(ins[3]) < -80 / 16).mean() > 0.01  # the chunk-16 clamp acts
    tt, jj = _both(ins, 3, dtype)
    got = wkv_tiles_plain(*tt, chunk=16, group=group)
    want = jax_ssm.wkv_chunked(*jj, chunk=16)
    assert got[0].shape == (B, S, H, N) and got[1].shape == (B, H, N, N)
    assert _share(got, want, WKV_TOL) <= 1.0


def test_wkv_tiles_plain_matches_the_pallas_kernel():
    """The reference op's (B, H, S, N) layout at chunk 32, Pallas wkv_kernel
    in interpret mode, groups of 2 chunks over a ragged S."""
    r, k, v, w, u, s0 = _wkv_inputs(7, 2, 150, 2, 32)
    bhsn = [np.swapaxes(a, 1, 2) for a in (r, k, v, w)]
    got_y, got_s = wkv_tiles_plain(*(torch_from(a) for a in (r, k, v, w, u, s0)), chunk=32, group=2)
    want_y, want_s = jax_wkv(*(jax_from(a) for a in (*bhsn, u, s0)), chunk=32, interpret=True)
    assert _share((got_y.transpose(1, 2), got_s), (want_y, want_s), WKV_TOL) <= 1.0


def test_wkv_group_plan():
    assert wkv_group_plan(128, 16) == (8, 1)   # the rwkv6 path: one group, no pass
    assert wkv_group_plan(4096, 16) == (4, 64)
    assert wkv_group_plan(129, 16) == (4, 3)
    assert wkv_group_plan(5, 16) == (1, 1)
    assert wkv_group_plan(200, 32) == (6, 2)  # 7 chunks of 32, but a walk block holds 6
    assert wkv_group_plan(500, 64) == (3, 3)  # a walk block holds 3 chunks of 64


# ----------------------------------------------------- products on bf16
def test_one_bf16_rounding_of_the_f32_operands_breaks_the_tolerance():
    """On bf16 tensor cores an f32 operand rounded to bf16 once (2^-9)
    misses SSD's tolerance many times over; in three pieces it stays far
    inside it.  Held against the plain version at the model's shapes, cut
    in heads and length.  (WKV's kernel forms its products in f32 on the
    FMA units, so it has no such split.)"""
    x, Bm, Cm, a, dt, s0 = _ssd_inputs(1, 1, 300, 2, 64, 64)
    tt = [torch_from(t, torch.bfloat16) for t in (x, Bm, Cm)] + [torch_from(t) for t in (a, dt, s0)]
    want = ssd_chunked_plain(*tt, 256)
    assert _share(ssd_tiles_plain(*tt, chunk=256, products="bf16"), want, SSD_TOL) > 10.0
    assert _share(ssd_tiles_plain(*tt, chunk=256, products="bf16x3"), want, SSD_TOL) < 0.1
