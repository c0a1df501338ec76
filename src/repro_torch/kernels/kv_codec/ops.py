"""Wrappers of the int8 KV codec kernels: any (..., C) tensor, the scale
per channel over every leading axis, as the reference's ``ops.py``.

A CUDA tensor launches ``csrc/kv_codec.cu``; a CPU tensor takes the plain
version in ``ref.py``; any other device raises.  There is no fallback
from the kernel to the plain version.  The reference pads C up to a
multiple of 128; the kernel masks the ragged channel edge itself, so
neither wrapper pads.

``quantize_plan`` and ``dequantize_plan`` pick each launch's shape from
shapes alone: the vector width (16 bytes a lane where the operands allow
it, else one element), the block, and for quantize one of two paths.  On
the one-pass path a block holds all T rows of its channel tile in
registers; on the split-T path a first kernel writes one partial absmax
per slab of rows and channel, and a second takes the max over the slabs
and quantizes its slab.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build
from .ref import dequantize_ref, quantize_ref, quantize_slabs_plain

# kernel launches since the last reset (``repro_torch.kernels.reset_launch_counts``)
quantize_launches = 0
dequantize_launches = 0

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
VECTOR_BYTES = 16     # one access a lane where the operands are aligned
THREADS = 256         # at most, a block
MIN_THREADS = 32      # at least, a block
ROWS_PER_THREAD = 4   # one pass: rows a lane keeps in registers (MAX_RPT in kv_codec.cu)
ONE_PASS_GROUPS = 16  # one pass: row groups a block has, at most
ONE_PASS_ROWS = ROWS_PER_THREAD * ONE_PASS_GROUPS  # one pass up to 64 rows
UNROLL = 4            # rows whose loads a lane issues together (UNROLL in kv_codec.cu)
SPLIT_LANES = 16      # split-T: lanes along C
SPLIT_GROUPS = 16     # split-T: row groups a block has
MAX_SLABS = 32        # split-T: partials the second kernel reads, per channel
MIN_SLAB_ROWS = 64
SPLIT_BLOCKS_PER_SM = 16
DEQUANT_GROUPS = 8    # dequantize: row groups a block has
DEQUANT_BLOCKS_PER_SM = 32
MIN_BLOCKS_PER_SM = 2  # lanes along C are cut until the grid has this many blocks an SM


class QuantizePlan(NamedTuple):
    path: str          # "one_pass" or "split_t"
    vec: int           # elements a lane loads at once
    tx: int            # lanes along C in a block: a tile of tx·vec channels
    ty: int            # row groups in a block: lane (i, j) takes rows j, j + ty, ... of its slab
    slab_rows: int     # rows a block owns (T on the one-pass path)
    n_slabs: int       # blocks along T
    channel_tiles: int  # blocks along C


class DequantizePlan(NamedTuple):
    vec: int           # codes a lane loads at once: one 16-byte store of outputs
    tx: int
    ty: int
    row_blocks: int    # blocks along T; a grid-stride loop over the rows
    channel_tiles: int


def quantize_plan(T: int, C: int, elem_bytes: int, aligned: bool, sm_count: int) -> QuantizePlan:
    """The quantize launch for x (T, C) of ``elem_bytes`` elements on a
    card of ``sm_count`` SMs.  ``aligned``: x starts on 16 bytes, and its
    row stride and C are whole 16-byte vectors; else a lane loads one
    element.  Up to ONE_PASS_ROWS rows one pass, a row a lane up to 16 rows,
    with the lanes along C cut until the grid has MIN_BLOCKS_PER_SM blocks
    an SM; above, split-T with up to MAX_SLABS slabs of at least
    MIN_SLAB_ROWS rows, for about SPLIT_BLOCKS_PER_SM blocks an SM.  (The
    block shapes and counts were chosen by timing on an H100.)"""
    vec = VECTOR_BYTES // elem_bytes if aligned else 1
    nvec = _cdiv(C, vec)
    if T <= ONE_PASS_ROWS:
        ty = min(ONE_PASS_GROUPS, 1 << (T - 1).bit_length())
        tx = _lanes(nvec, ty, 1, sm_count)
        return QuantizePlan("one_pass", vec, tx, ty, T, 1, _cdiv(nvec, tx))
    tx, ty = SPLIT_LANES, SPLIT_GROUPS
    tiles = _cdiv(nvec, tx)
    n = max(1, min(MAX_SLABS, _cdiv(SPLIT_BLOCKS_PER_SM * sm_count, tiles), T // MIN_SLAB_ROWS))
    step = UNROLL * ty
    slab_rows = _cdiv(_cdiv(T, n), step) * step
    return QuantizePlan("split_t", vec, tx, ty, slab_rows, _cdiv(T, slab_rows), tiles)


def dequantize_plan(T: int, C: int, out_bytes: int, aligned: bool, sm_count: int) -> DequantizePlan:
    """The dequantize launch for q (T, C) into ``out_bytes`` outputs: where
    q and the scale start on 16 bytes and C is whole vectors, a lane reads
    16 / out_bytes codes and writes them in one 16-byte store (a warp's
    stores contiguous), else one; DEQUANT_GROUPS rows a block, and about
    DEQUANT_BLOCKS_PER_SM blocks an SM."""
    vec = VECTOR_BYTES // out_bytes if aligned else 1
    nvec = _cdiv(C, vec)
    ty = DEQUANT_GROUPS
    tx = _lanes(nvec, ty, _cdiv(T, ty), sm_count)
    tiles = _cdiv(nvec, tx)
    row_blocks = max(1, min(_cdiv(T, ty), 65535, _cdiv(DEQUANT_BLOCKS_PER_SM * sm_count, tiles)))
    return DequantizePlan(vec, tx, ty, row_blocks, tiles)


def _lanes(nvec: int, ty: int, row_blocks: int, sm_count: int) -> int:
    """Lanes along C for a block of ``ty`` row groups: THREADS // ty, halved
    while the grid has fewer than MIN_BLOCKS_PER_SM blocks an SM, down to
    MIN_THREADS."""
    tx = THREADS // ty
    while tx * ty > MIN_THREADS and _cdiv(nvec, tx) * row_blocks < MIN_BLOCKS_PER_SM * sm_count:
        tx //= 2
    return tx


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def quantize(x):
    """x (..., C) float32, bfloat16 or float16 -> (q int8 (..., C), scale
    float32 (C,)): scale = absmax/127 per channel (1.0 where a channel is
    all zero), q = clip(round_half_even(x / scale), -127, 127)."""
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"quantize takes {list(DTYPE_CODES)}, got {x.dtype}")
    if x.dim() == 0 or x.numel() == 0:
        raise ValueError(f"quantize needs a non-empty (..., C) tensor, got shape {tuple(x.shape)}")
    return _build.run_on("quantize", x.device, lambda: quantize_ref(x), lambda: _launch_quantize(x), inputs=(x,))


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
                         lambda: _launch_dequantize(q, scale, out_dtype), inputs=(q, scale))


def plan_for_quantize(x) -> QuantizePlan:
    """The plan ``quantize(x)`` launches on x's card."""
    return _quantize_setup(x)[1]


def plan_for_dequantize(q, scale, out_dtype=torch.bfloat16) -> DequantizePlan:
    """The plan ``dequantize(q, scale, out_dtype=out_dtype)`` launches on q's card."""
    return _dequantize_setup(q, scale, out_dtype)[2]


def vector_aligned(t, vec: int) -> bool:
    """Whether lanes can move ``t`` (rows, C) in vectors of ``vec``
    elements: its start on 16 bytes, its row stride and C whole vectors."""
    return t.data_ptr() % VECTOR_BYTES == 0 and t.stride(0) % vec == 0 and t.shape[1] % vec == 0


def _quantize_setup(x):
    xf = x.reshape(-1, x.shape[-1])  # a view where the layout allows, else a copy
    if xf.stride(1) != 1:
        xf = xf.contiguous()
    aligned = vector_aligned(xf, VECTOR_BYTES // xf.element_size())
    return xf, quantize_plan(*xf.shape, xf.element_size(), aligned, _build.sm_count(x.device))


def _dequantize_setup(q, scale, out_dtype):
    C = q.shape[-1]
    qf, sf = q.reshape(-1, C).contiguous(), scale.reshape(C).to(torch.float32).contiguous()
    out_bytes = out_dtype.itemsize
    aligned = vector_aligned(qf, VECTOR_BYTES // out_bytes) and sf.data_ptr() % VECTOR_BYTES == 0
    return qf, sf, dequantize_plan(*qf.shape, out_bytes, aligned, _build.sm_count(q.device))


def _launch_quantize(x):
    global quantize_launches
    xf, plan = _quantize_setup(x)
    T, C = xf.shape
    q = torch.empty((T, C), dtype=torch.int8, device=x.device)
    scale = torch.empty(C, dtype=torch.float32, device=x.device)
    split = plan.path == "split_t"
    ws = torch.empty((plan.n_slabs, C), dtype=torch.float32, device=x.device) if split else None
    lib = _build.bind("kv_codec", _SIGNATURES)
    _build.call(lib, "kv_codec", "kv_codec_quantize", x.device, DTYPE_CODES[x.dtype], xf.data_ptr(),
                q.data_ptr(), scale.data_ptr(), ws.data_ptr() if split else None, T, C, xf.stride(0),
                plan.vec, plan.tx, plan.ty, int(split), plan.slab_rows, plan.n_slabs)
    quantize_launches += 1
    return q.view(x.shape), scale


def _launch_dequantize(q, scale, out_dtype):
    global dequantize_launches
    qf, sf, plan = _dequantize_setup(q, scale, out_dtype)
    T, C = qf.shape
    out = torch.empty((T, C), dtype=out_dtype, device=q.device)
    if T == 0:
        return out.view(q.shape)
    lib = _build.bind("kv_codec", _SIGNATURES)
    _build.call(lib, "kv_codec", "kv_codec_dequantize", q.device, DTYPE_CODES[out_dtype], qf.data_ptr(),
                sf.data_ptr(), out.data_ptr(), T, C, plan.vec, plan.tx, plan.ty, plan.row_blocks)
    dequantize_launches += 1
    return out.view(q.shape)


_SIGNATURES = {
    "kv_codec_quantize": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p,
    ]),
    "kv_codec_dequantize": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]),
}


__all__ = ["quantize", "dequantize", "quantize_ref", "dequantize_ref", "quantize_slabs_plain",
           "quantize_plan", "dequantize_plan", "plan_for_quantize", "plan_for_dequantize", "vector_aligned"]
