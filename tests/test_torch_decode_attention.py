"""The port's paged decode (plain version, which its wrapper runs for CPU
tensors) against the reference's Pallas kernel in interpret mode, on the
same numpy inputs, including the kv_len = 0 row where the reference kernel
gives zeros (and its ``ref.py`` does not)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from parity_harness import BF16_TOL, F32_TOL, jax_from, np32, torch_from

from repro.kernels.decode_attention import paged_decode as jax_paged_decode
from repro.kernels.decode_attention import paged_decode_ref as jax_paged_decode_ref
from repro_torch.kernels.decode_attention import paged_decode


def _inputs(seed, B, H, KVH, D, page, NB, P, lo=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D))
    kp = rng.standard_normal((P, page, KVH, D))
    vp = rng.standard_normal((P, page, KVH, D))
    tables = rng.integers(0, P, (B, NB)).astype(np.int32)
    lens = rng.integers(lo, NB * page + 1, (B,)).astype(np.int32)
    return q, kp, vp, tables, lens


def _run_both(q, kp, vp, tables, lens, tdtype, jdtype):
    got = paged_decode(torch_from(q, tdtype), torch_from(kp, tdtype), torch_from(vp, tdtype),
                       torch.from_numpy(tables), torch.from_numpy(lens))
    want = jax_paged_decode(jax_from(q, jdtype), jax_from(kp, jdtype), jax_from(vp, jdtype),
                            jnp.asarray(tables), jnp.asarray(lens), interpret=True)
    return got, want


# the reference kernel test's cases (tests/test_kernels.py:56-73)
@pytest.mark.parametrize("B,H,KVH,D,page,NB,P",
                         [(2, 8, 2, 64, 16, 4, 12), (3, 4, 4, 128, 8, 3, 10), (1, 16, 1, 64, 32, 2, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_matches_reference_kernel(B, H, KVH, D, page, NB, P, dtype):
    tdtype, jdtype = (torch.float32, jnp.float32) if dtype == "float32" else (torch.bfloat16, jnp.bfloat16)
    got, want = _run_both(*_inputs(B * 1000 + H, B, H, KVH, D, page, NB, P), tdtype, jdtype)
    assert got.dtype == tdtype
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(np32(got), np32(want), rtol=tol, atol=tol)


def test_paged_decode_single_valid_token():
    """kv_len=1: only the first slot of the first page participates
    (tests/test_kernels.py:76-89)."""
    q, kp, vp, _, _ = _inputs(5, 1, 2, 1, 64, 8, 2, 4)
    out = paged_decode(torch_from(q), torch_from(kp), torch_from(vp),
                       torch.tensor([[2, 0]], dtype=torch.int32), torch.tensor([1], dtype=torch.int32))
    np.testing.assert_allclose(np32(out)[0, 0], vp[2, 0, 0], rtol=1e-5, atol=1e-5)


def test_paged_decode_ragged_lengths_and_g5():
    """kv_len not page-aligned, G = 5 as in qwen3-14b (40 heads over 8)."""
    q, kp, vp, tables, _ = _inputs(9, 3, 10, 2, 32, 16, 5, 20)
    lens = np.array([17, 33, 79], np.int32)
    got, want = _run_both(q, kp, vp, tables, lens, torch.float32, jnp.float32)
    np.testing.assert_allclose(np32(got), np32(want), rtol=F32_TOL, atol=F32_TOL)


def test_paged_decode_kv_len_zero_gives_zeros_like_the_kernel():
    """kv_len = 0: the reference kernel returns zeros (l stays 0); its
    ref.py returns the mean of the gathered V.  The port follows the kernel."""
    q, kp, vp, tables, _ = _inputs(13, 3, 4, 2, 16, 8, 3, 9)
    lens = np.array([0, 5, 24], np.int32)
    got, want = _run_both(q, kp, vp, tables, lens, torch.float32, jnp.float32)
    np.testing.assert_array_equal(np32(got)[0], np.zeros((4, 16), np.float32))
    np.testing.assert_allclose(np32(got), np32(want), rtol=F32_TOL, atol=F32_TOL)
    ref_row0 = np32(jax_paged_decode_ref(jax_from(q), jax_from(kp), jax_from(vp),
                                         jnp.asarray(tables), jnp.asarray(lens)))[0]
    assert np.abs(ref_row0).max() > 0  # the disagreement the port pins


def test_paged_decode_wrapper_checks_its_inputs():
    q, kp = torch.zeros(1, 4, 16), torch.zeros(3, 4, 2, 16)
    tables, lens = torch.zeros(1, 2, dtype=torch.int32), torch.ones(1, dtype=torch.int32)
    with pytest.raises(TypeError):
        paged_decode(q, kp, kp, tables.long(), lens)
    with pytest.raises(TypeError):
        paged_decode(q.double(), kp.double(), kp.double(), tables, lens)
    with pytest.raises(ValueError):
        paged_decode(q, kp, kp, torch.zeros(2, 2, dtype=torch.int32), lens)
    with pytest.raises(ValueError):  # neither the card nor the CPU: no plain fallback
        paged_decode(*(t.to("meta") for t in (q, kp, kp, tables, lens)))
