"""The comparison's own pieces: the stored block layout read back as the
program writes it, the relative error, and the verdict's rules."""

import math

import numpy as np
import pytest
import torch

from kvbench import check
from kvbench.arch import dense_gqa


def dims(L, KVH, Dh):
    return {"n_layers": L, "n_kv_heads": KVH, "d_head": Dh}


def test_unpack_inverts_the_programs_block_layout():
    from repro_torch.serving.real_prefill import fortran_blocks

    L, T, KVH, Dh, blk = 3, 48, 2, 8, 16
    g = torch.Generator().manual_seed(0)
    k, v = torch.randn(L, T, KVH, Dh, generator=g), torch.randn(L, T, KVH, Dh, generator=g)
    stored = torch.cat([fortran_blocks(k.half(), blk), fortran_blocks(v.half(), blk)], dim=2).numpy()
    got = dense_gqa.unpack_blocks(list(stored), dims(L, KVH, Dh), "cpu")
    assert torch.equal(got["k"], k.half().float()) and torch.equal(got["v"], v.half().float())
    # numpy's own Fortran-order reshape of one slab, as the layout is defined
    slab = k.half().numpy()[:, 16:32].reshape(blk, -1, order="F")
    assert np.array_equal(stored[1][:, : L * KVH * Dh], slab)


def test_unpack_refuses_missing_or_misshapen_blocks():
    ok = np.zeros((16, 2 * 3 * 2 * 8), np.float16)
    m = dims(3, 2, 8)
    assert dense_gqa.unpack_blocks([ok, None], m, "cpu") is None
    assert dense_gqa.unpack_blocks([ok[:, :10]], m, "cpu") is None
    assert dense_gqa.unpack_blocks([], m, "cpu")["k"].shape == (3, 0, 2, 8)


def test_rel_err():
    ref = torch.tensor([1.0, -4.0, 2.0])
    assert check.rel_err(ref + torch.tensor([0.0, 0.2, 0.0]), ref) == pytest.approx(0.05)
    assert check.rel_err(ref[:2], ref) == math.inf


def test_verdict():
    assert check.verdict({"a": 0.1, "b": 0.0}, {"a": 0.2, "b": 0.0})
    assert not check.verdict({"a": 0.3, "b": 0.0}, {"a": 0.2, "b": 0.0})
    assert not check.verdict({"a": math.inf}, {"a": 0.2})
    assert not check.verdict({"a": math.nan}, {"a": 0.2})
    assert not check.verdict({"a": 0.1}, {"a": 0.2, "b": 0.0})  # a number missing
    assert not check.verdict({"a": 0.1}, None)  # a cell without limits


def test_trace_summary_busy_gaps_and_kernels():
    from types import SimpleNamespace as NS

    from kvbench import trace

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, s, e, dev=cuda):
        return NS(name=name, device_type=dev, time_range=NS(start=s, end=e))

    events = [ev("void (anonymous namespace)::tc::flash_bf16_kernel<128, 128>(x)", 0, 100),
              ev("nvjet_gemm", 50, 300), ev("paged_decode_join_kernel<float>", 1300, 1400),
              ev("kvbench.prefill", 0, 5000),  # a user annotation on the device side: not an operation
              ev("aten::mm", 0, 10, cpu)]
    host = [("fetch", 200, 2000), ("plan", 900, 1000)]
    out = trace.summarise(events, 0.01, host)
    assert out["busy_s"] == pytest.approx(400e-6)
    assert out["kernels"]["flash"] == [1, pytest.approx(100e-6)]
    assert out["kernels"]["paged_decode"] == [1, pytest.approx(100e-6)]
    assert out["idle_gaps"] == [["fetch", pytest.approx(1000e-6)]]
    assert [o[0] for o in out["device_ops"]][0] == "nvjet_gemm"
    # the gap's midpoint (800) lies in fetch only; one at 950 would be plan's
    assert trace.summarise(events, 0.01, [("fetch", 200, 2000), ("plan", 700, 900)])["idle_gaps"][0][0] == "plan"
