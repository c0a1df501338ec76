"""rwkv6's bf16 gate in chip_smoke.py (phase rwkv6): each layer's WKV scan
through the kernel against its plain version on that layer's own inputs,
at phase wkv's tolerance (atol = rtol = WKV_TOL, 3e-4).  Here the gate is
built on the plain versions, on the CPU: it passes an unperturbed scan and
one whose error sits just inside the tolerance, and fails a scan whose
output or final state carries an error just beyond it."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from repro_torch.kernels.rwkv6 import wkv_chunked_plain  # noqa: E402

LAYERS, B, S, H, N, CHUNK = 3, 1, 40, 2, 8, 16  # a ragged last chunk
TOL = chip_smoke.WKV_TOL


def _records():
    """Per layer (r, k, v, w, u, state, chunk) as the model hands them to
    the scan: bf16 r/k/v, the model's decay w = exp(-exp(x)) (the clamp
    acts), f32 u and a carried f32 state; from numpy with a seed."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(LAYERS):
        r, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, N)).astype(np.float32)).bfloat16()
                   for _ in range(3))
        w = torch.exp(-torch.exp(torch.from_numpy(rng.standard_normal((B, S, H, N)).astype(np.float32))))
        u = torch.from_numpy(rng.standard_normal((H, N)).astype(np.float32) * 0.3)
        s = torch.from_numpy(rng.standard_normal((B, H, N, N)).astype(np.float32) * 0.5)
        out.append((r, k, v, w, u, s, CHUNK))
    return out


def _planted(scale: float, on: str):
    """The plain scan with one entry of the last layer's ``on`` ("y" or
    "state") moved by ``scale`` times the tolerance's limit there,
    atol + rtol |value|."""
    calls = []

    def scan(r, k, v, w, u, state, chunk):
        y, s = wkv_chunked_plain(r, k, v, w, u, state, chunk)
        calls.append(None)
        if len(calls) == LAYERS:
            t = y if on == "y" else s
            at = (0, -1, 1, 3) if on == "y" else (0, 1, 3, 5)
            t[at] += scale * (TOL + TOL * t[at].abs())
        return y, s

    return scan


def test_gate_passes_the_plain_scan():
    err, share, _ = chip_smoke.wkv_layer_gate(_records(), wkv_chunked_plain)
    assert err == 0.0 and share == 0.0


@pytest.mark.parametrize("on", ["y", "state"])
def test_gate_passes_an_error_just_inside_the_tolerance(on):
    _, share, where = chip_smoke.wkv_layer_gate(_records(), _planted(0.99, on))
    assert 0.98 < share <= 1.0 and where == f"layer{LAYERS - 1}_{on}"


@pytest.mark.parametrize("on", ["y", "state"])
def test_gate_fails_an_error_just_beyond_the_tolerance(on):
    with pytest.raises(AssertionError, match=f"rwkv6 layer {LAYERS - 1} WKV {on}"):
        chip_smoke.wkv_layer_gate(_records(), _planted(1.01, on))
