"""Plain PyTorch version of the int8 KV codec kernels, in f32 throughout:
the same function as ``csrc/kv_codec.cu`` and as the host codec
``core/codec.py::quantize_int8`` (scale = absmax/127 over every leading
axis, 1.0 for an all-zero channel; q rounded half to even, as
``torch.round`` and ``np.round`` both do).  Runs on any device.

``quantize_slabs_plain`` is the split-T path's arithmetic: a partial
absmax per slab of rows, the max over the slabs, then the quantize."""

from __future__ import annotations

import torch


def quantize_ref(x):
    """x (..., C) -> (q int8 (..., C), scale f32 (C,))."""
    xf = x.to(torch.float32)
    return _quantize(xf, xf.abs().reshape(-1, xf.shape[-1]).amax(dim=0))


def quantize_slabs_plain(x, slab_rows: int):
    """``quantize_ref`` computed as the split-T kernels do: x flattened to
    (T, C), each slab of ``slab_rows`` rows (the last may be shorter) gives
    a partial absmax per channel, and the scale comes from the max over the
    slabs.  A max does not depend on its order, so this is bit for bit
    ``quantize_ref``."""
    xf = x.to(torch.float32)
    rows = xf.reshape(-1, xf.shape[-1])
    partial = torch.stack([slab.abs().amax(dim=0) for slab in rows.split(slab_rows)])  # (n_slabs, C)
    return _quantize(xf, partial.amax(dim=0))


def _quantize(xf, absmax):
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which can sit one ulp off numpy's absmax / 127
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0), torch.ones_like(absmax))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_ref(q, scale, dtype=torch.bfloat16):
    """q (..., C) int8, scale (C,) -> q·scale in f32, cast to ``dtype``."""
    return (q.to(torch.float32) * scale.to(torch.float32)).to(dtype)
