"""Wrapper of the paged decode-attention kernel: model layout (B, H, D).

A CUDA tensor launches ``csrc/decode_attention.cu``; a CPU tensor takes the
plain version in ``ref.py``; any other device raises.  There is no
fallback from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import paged_decode_ref

# kernel launches since the last reset (``repro_torch.kernels.reset_launch_counts``)
launches = 0

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
SMEM_LIMIT = 227 * 1024  # dynamic shared memory one block may use on sm_90


def _check(q, k_pages, v_pages, block_tables, kv_len) -> None:
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError("paged_decode expects q (B,H,D) and k/v pages (P,page,KVH,D)")
    B, H, D = q.shape
    if v_pages.shape != k_pages.shape or k_pages.shape[3] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k_pages.shape)}, v {tuple(v_pages.shape)}")
    KVH = k_pages.shape[2]
    if H % KVH:
        raise ValueError(f"n_heads {H} is not a multiple of n_kv_heads {KVH}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B or kv_len.shape != (B,):
        raise ValueError(f"block_tables must be (B, NB) and kv_len (B,), got "
                         f"{tuple(block_tables.shape)} and {tuple(kv_len.shape)}")
    if block_tables.dtype != torch.int32 or kv_len.dtype != torch.int32:
        raise TypeError("block_tables and kv_len must be int32")
    if not (q.dtype == k_pages.dtype == v_pages.dtype) or q.dtype not in DTYPE_CODES:
        raise TypeError(f"q and pages must share one of {list(DTYPE_CODES)}, got "
                        f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    devs = {t.device for t in (q, k_pages, v_pages, block_tables, kv_len)}
    if len(devs) != 1:
        raise ValueError(f"all operands must be on one device, got {devs}")


def paged_decode(q, k_pages, v_pages, block_tables, kv_len):
    """q (B, H, D); k/v_pages (P, page, KVH, D); block_tables (B, NB) int32;
    kv_len (B,) int32 -> (B, H, D) in q's dtype.  Slots at or past kv_len
    are masked; a row with kv_len = 0 gives zeros."""
    _check(q, k_pages, v_pages, block_tables, kv_len)
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_pages, v_pages, block_tables, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode runs on cuda (kernel) or cpu (plain), not {q.device}")
    return _launch(q, k_pages, v_pages, block_tables, kv_len)


def _launch(q, k_pages, v_pages, block_tables, kv_len):
    global launches
    B, H, D = q.shape
    _, page, KVH, _ = k_pages.shape
    G = H // KVH
    NB = block_tables.shape[1]
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {D}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("kv_len", kv_len)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("k/v pages must start on 16 bytes (the kernel gathers 16-byte loads)")
    lib = _bind()
    if lib.paged_decode_smem_bytes(G, D) > SMEM_LIMIT:
        raise ValueError(f"G={G}, D={D} needs more shared memory than one block has")
    o = torch.empty_like(q)
    if B == 0:
        return o
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.paged_decode_fwd(
            DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), kv_len.data_ptr(), o.data_ptr(),
            B, KVH, G, D, page, NB, float(D**-0.5), stream)
    _build.check(lib, "paged_decode", status)
    launches += 1
    return o


_lib = None


def _bind():
    global _lib
    if _lib is None:
        lib = _build.load("decode_attention")
        lib.paged_decode_fwd.restype = ctypes.c_int
        lib.paged_decode_fwd.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_void_p,
        ]
        lib.paged_decode_smem_bytes.restype = ctypes.c_size_t
        lib.paged_decode_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        _lib = lib
    return _lib


__all__ = ["paged_decode", "paged_decode_ref"]
