"""Wrappers of the flash-attention kernel in model layout (B, S, H, D):
``flash_attention`` (the reference wrapper's contract) and
``flash_attention_full`` (every key visible, any key count: an encoder's
self-attention and cross-attention).  V's head dim may differ from q's and
k's (MLA: 96 and 64).

A CUDA tensor launches ``csrc/flash_attention.cu``; a CPU tensor takes the
plain version in ``ref.py``; any other device raises.  There is no
fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import attention_ref, flash_attention_plain

# kernel launches since the last reset (``repro_torch.kernels.reset_launch_counts``)
launches = 0

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (q/k head dim, v head dim) pairs the kernel is instantiated for
HEAD_DIMS = ((32, 32), (64, 64), (112, 112), (128, 128), (96, 64))


def _check(q, k, v, q_offset: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention expects q (B,Sq,H,D), k (B,Skv,KVH,D) and v (B,Skv,KVH,Dv)")
    B, Sq, H, D = q.shape
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    KVH = k.shape[2]
    if (H % KVH) if KVH else H:  # no KV heads only with no heads (an empty part of a split)
        raise ValueError(f"n_heads {H} is not a multiple of n_kv_heads {KVH}")
    if Sq == 0 or k.shape[1] == 0:
        raise ValueError("flash_attention needs at least one query and one key")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPE_CODES:
        raise TypeError(f"q/k/v must share one of {list(DTYPE_CODES)}, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    block_q: int = 128, block_k: int = 128):
    """q (B, Sq, H, D); k (B, Skv, KVH, D); v (B, Skv, KVH, Dv) -> (B, Sq,
    H, Dv) in q's dtype, scores scaled by D^-0.5.

    Query i sits at absolute position ``q_offset + i``.  ``block_q`` and
    ``block_k`` keep the reference wrapper's contract: a non-causal call
    whose Skv is not a multiple of ``min(block_k, max(8, Skv))`` raises,
    because the reference pads keys it cannot mask.  The kernel itself tiles
    64 x 64 and masks ragged edges, so it needs no padding."""
    del block_q  # the reference's query block; nothing depends on it here
    _check(q, k, v, q_offset)
    Skv = k.shape[1]
    bk = min(block_k, max(8, Skv))
    if not causal and Skv % bk:
        raise ValueError("non-causal flash requires Skv % block_k == 0 (pad keys are unmaskable)")
    return _build.run_on("flash_attention", q.device, lambda: flash_attention_plain(q, k, v, causal, q_offset),
                         lambda: _launch(q, k, v, causal, q_offset), inputs=(q, k, v))


def flash_attention_full(q, k, v):
    """Full (non-causal) attention of every query over every key: q (B, Sq,
    H, D); k (B, Skv, KVH, D); v (B, Skv, KVH, Dv) -> (B, Sq, H, Dv) in q's
    dtype.  Skv may be any length (whisper's 1500 encoder frames): the
    kernel masks keys past Skv in its last tile, so nothing is padded and
    no block multiple is asked for, unlike ``flash_attention``'s
    non-causal contract."""
    _check(q, k, v, 0)
    return _build.run_on("flash_attention", q.device, lambda: flash_attention_plain(q, k, v, False, 0),
                         lambda: _launch(q, k, v, False, 0), inputs=(q, k, v))


def _launch(q, k, v, causal: bool, q_offset: int):
    global launches
    B, Sq, H, D = q.shape
    Skv, KVH, Dv = k.shape[1], k.shape[2], v.shape[3]
    if H == 0:  # a rank's empty part of a split over heads: nothing to launch
        return torch.empty((B, Sq, 0, Dv), dtype=q.dtype, device=q.device)
    if (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"the kernel takes (q/k, v) head dims {HEAD_DIMS}, got {(D, Dv)}")
    vec = 16 // q.element_size()  # the kernel moves tiles in 16-byte loads
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or (t.shape[2] > 1 and t.stride(2) != t.shape[3]):
            raise ValueError(f"{name} must be contiguous over (heads, head_dim); strides {t.stride()}")
        if t.data_ptr() % 16 or t.stride(0) % vec or t.stride(1) % vec:
            raise ValueError(f"{name} must start on 16 bytes with batch/sequence strides of "
                             f"whole 16-byte units; strides {t.stride()}")
    o = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lib = _build.bind("flash_attention", _SIGNATURES)
    strides = (ctypes.c_int64 * 8)(q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                                   v.stride(0), v.stride(1), o.stride(0), o.stride(1))
    _build.call(lib, "flash_attention", "flash_attention_fwd", q.device,
                DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                B, H, KVH, Sq, Skv, D, Dv, strides, int(causal), int(q_offset), float(D**-0.5))
    launches += 1
    return o


def design(dtype: torch.dtype) -> str:
    """The kernel the library runs for ``dtype``, as it reports it."""
    return _build.bind("flash_attention", _SIGNATURES).flash_attention_design(DTYPE_CODES[dtype]).decode()


_SIGNATURES = {
    "flash_attention_fwd": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p,
    ]),
    "flash_attention_design": (ctypes.c_char_p, [ctypes.c_int]),
}


__all__ = ["design", "flash_attention", "flash_attention_full", "attention_ref", "flash_attention_plain"]
