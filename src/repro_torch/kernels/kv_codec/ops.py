"""Wrappers of the int8 KV codec kernels: any (..., C) tensor, the scale
per channel over every leading axis, as the reference's ``ops.py``.

A CUDA tensor launches ``csrc/kv_codec.cu``; a CPU tensor takes the plain
version in ``ref.py``; any other device raises.  There is no fallback
from the kernel to the plain version.  The reference pads C up to a
multiple of 128; the kernel masks the ragged channel edge itself, so
neither wrapper pads.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import dequantize_ref, quantize_ref

# kernel launches since the last reset (``repro_torch.kernels.reset_launch_counts``)
quantize_launches = 0
dequantize_launches = 0

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def quantize(x):
    """x (..., C) float32, bfloat16 or float16 -> (q int8 (..., C), scale
    float32 (C,)): scale = absmax/127 per channel (1.0 where a channel is
    all zero), q = clip(round_half_even(x / scale), -127, 127)."""
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"quantize takes {list(DTYPE_CODES)}, got {x.dtype}")
    if x.dim() == 0 or x.numel() == 0:
        raise ValueError(f"quantize needs a non-empty (..., C) tensor, got shape {tuple(x.shape)}")
    return _build.run_on("quantize", x.device, lambda: quantize_ref(x), lambda: _launch_quantize(x))


def dequantize(q, scale, *, out_dtype=torch.bfloat16):
    """q (..., C) int8, scale (C,) -> q·scale computed in f32, cast to
    ``out_dtype`` (bfloat16, float32 or float16)."""
    if q.dtype != torch.int8:
        raise TypeError(f"dequantize takes int8 q, got {q.dtype}")
    if out_dtype not in DTYPE_CODES:
        raise TypeError(f"dequantize writes {list(DTYPE_CODES)}, got {out_dtype}")
    if q.dim() == 0 or scale.numel() != q.shape[-1]:
        raise ValueError(f"scale must hold one value per channel: q {tuple(q.shape)}, scale {tuple(scale.shape)}")
    if q.device != scale.device:
        raise ValueError("q and scale must be on one device")
    return _build.run_on("dequantize", q.device, lambda: dequantize_ref(q, scale.reshape(-1), out_dtype),
                         lambda: _launch_dequantize(q, scale, out_dtype))


def _launch_quantize(x):
    global quantize_launches
    C = x.shape[-1]
    xf = x.reshape(-1, C)  # a view where the layout allows, else a copy
    if xf.stride(1) != 1:
        xf = xf.contiguous()
    q = torch.empty(xf.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty(C, dtype=torch.float32, device=x.device)
    lib = _build.bind("kv_codec", _SIGNATURES)
    _build.call(lib, "kv_codec", "kv_codec_quantize", x.device, DTYPE_CODES[x.dtype], xf.data_ptr(),
                q.data_ptr(), scale.data_ptr(), xf.shape[0], C, xf.stride(0))
    quantize_launches += 1
    return q.view(x.shape), scale


def _launch_dequantize(q, scale, out_dtype):
    global dequantize_launches
    C = q.shape[-1]
    qf = q.reshape(-1, C).contiguous()
    sf = scale.reshape(C).to(torch.float32).contiguous()
    out = torch.empty(qf.shape, dtype=out_dtype, device=q.device)
    if qf.shape[0] == 0:
        return out.view(q.shape)
    lib = _build.bind("kv_codec", _SIGNATURES)
    _build.call(lib, "kv_codec", "kv_codec_dequantize", q.device, DTYPE_CODES[out_dtype], qf.data_ptr(),
                sf.data_ptr(), out.data_ptr(), qf.shape[0], C)
    dequantize_launches += 1
    return out.view(q.shape)


_SIGNATURES = {
    "kv_codec_quantize": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
    ]),
    "kv_codec_dequantize": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ]),
}


__all__ = ["quantize", "dequantize", "quantize_ref", "dequantize_ref"]
