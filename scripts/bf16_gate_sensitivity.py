#!/usr/bin/env python3
"""How far rounding alone moves rwkv6-1.6b's bf16 logits on the card.

    python3 scripts/bf16_gate_sensitivity.py

chip_smoke.py held each recurrent model's kernel path against its plain
path in bf16, teacher-forced, at 5 % of max |logit|.  This prints that gap
for full-width rwkv6-1.6b from seeds 0 and 1, two ways: with the WKV
kernel, and with the scan evaluated in float64 by its plain version and
rounded to f32 (more exact than either path).  It also prints the share of
the scan's outputs and final state that the kernel gives bit for bit as
the plain version at the model's shape, and, at both seeds, the gate that
replaced rwkv6's bf16 logit gate in chip_smoke.py: each layer's WKV kernel
against its plain version on that layer's own inputs
(``chip_smoke.wkv_layer_gate``, atol = rtol 3e-4).  Needs one CUDA device.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.rwkv6 import wkv_chunked_plain, wkv_model  # noqa: E402
from repro_torch.launch.serve_e2e import greedy_decode  # noqa: E402
from repro_torch.models import api  # noqa: E402

PROMPT, DECODE = 128, 8  # chip_smoke.py's prompt and decode lengths


def wkv_f64(r, k, v, w, u, state, chunk: int = 16):
    """The plain version's arithmetic in float64, rounded to f32."""
    y, s = wkv_chunked_plain(r, k, v, w, u, state, chunk, dtype=torch.float64)
    return y.float(), s.float()


def bit_identical_share():
    g = torch.Generator(device="cuda").manual_seed(2)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    r, k, v = (rand(1, PROMPT, 32, 64).bfloat16() for _ in range(3))
    w = torch.exp(-torch.exp(rand(1, PROMPT, 32, 64)))  # the model's decay: the clamp acts
    u, s0 = rand(32, 64, scale=0.3), rand(1, 32, 64, 64, scale=0.5)
    (yk, sk), (yp, sp) = wkv_model(r, k, v, w, u, s0), wkv_chunked_plain(r, k, v, w, u, s0, 16)
    print(f"[scan] B1 S{PROMPT} H32 N64 chunk16 bf16: y bit for bit {float((yk == yp).float().mean()):.4f}, "
          f"state bit for bit {float((sk == sp).float().mean()):.4f}", flush=True)


def gate_gap(seed: int, scan: str) -> None:
    cfg = get_config("rwkv6-1.6b")
    params = api.init_params(cfg, seed, "cuda")
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size, PROMPT).tolist()
    # the kernel path, or the plain path with the float64 scan in its place
    # (rwkv6's only kernel is the scan)
    _, fed, logits = greedy_decode(cfg, params, prompt, DECODE, "cuda", plain_kernels=wkv_f64 if scan == "f64" else False)
    _, _, plain = greedy_decode(cfg, params, prompt, DECODE, "cuda", plain_kernels=True, inputs=fed)
    gap, scale = float((logits.float() - plain.float()).abs().max()), float(plain.float().abs().max())
    print(f"[gate] rwkv6-1.6b seed {seed} scan={scan}: max |dlogit| {gap:.4f} = {gap / scale:.4f} of max |logit| "
          f"(chip_smoke.py gate 0.05)", flush=True)
    del params
    torch.cuda.empty_cache()


def layer_gate(seed: int) -> None:
    import chip_smoke

    cfg = get_config("rwkv6-1.6b")
    params = api.init_params(cfg, seed, "cuda")
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size, PROMPT).tolist()
    _, fed, _ = greedy_decode(cfg, params, prompt, DECODE, "cuda")
    records = chip_smoke.wkv_layer_inputs(cfg, params, prompt, fed)
    err, share, where = chip_smoke.wkv_layer_gate(records, lambda *a: wkv_model(*a[:6], chunk=a[6]))
    print(f"[layer-gate] rwkv6-1.6b seed {seed}: {len(records)} layers, WKV kernel vs plain max |err| {err:.3e}, "
          f"{share:.3f} of the limit at {where} (atol = rtol {chip_smoke.WKV_TOL}): passed", flush=True)
    del params, records
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("bf16_gate_sensitivity: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)}", flush=True)
    bit_identical_share()
    for seed in (0, 1):
        for scan in ("kernel", "f64"):
            gate_gap(seed, scan)
        layer_gate(seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
