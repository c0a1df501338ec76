"""Wrapper of the paged decode-attention kernel: model layout (B, H, D).

A CUDA tensor launches ``csrc/decode_attention.cu``; a CPU tensor takes the
plain version in ``ref.py``; any other device raises.  There is no
fallback from the kernel to the plain version.

The kernel splits each (sequence, KV head)'s slot range across blocks and
joins the partial softmaxes in a second kernel; ``split_plan`` picks the
split from shapes alone, so no call reads ``kv_len`` on the host.  The
pages may be a strided view (``page_strides``: a rank's KV heads of a
whole cache under a split over ``model``); the kernel reads them in place.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import paged_decode_ref

# kernel launches since the last reset (``repro_torch.kernels.reset_launch_counts``)
launches = 0

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 112, 128)
SMEM_LIMIT = 227 * 1024  # dynamic shared memory one block may use on sm_90
# the split rule: at most SPLIT_MAX_TOKENS slots per block, so one long
# sequence is not one block's serial walk; about two blocks per SM when
# B·KVH is small; no split under SPLIT_MIN_TOKENS slots; split lengths a
# multiple of SPLIT_ALIGN slots
SPLIT_MIN_TOKENS = 32
SPLIT_MAX_TOKENS = 512
SPLIT_ALIGN = 16
BLOCKS_PER_SM = 2


def split_plan(B: int, KVH: int, slots: int, sm_count: int):
    """(n_splits, split_len) for B sequences of KVH heads over a block
    table of ``slots`` = NB·page slots on a card of ``sm_count`` SMs.
    Split s covers slots [s·split_len, (s+1)·split_len); the splits cover
    every slot of the table.  Reads no kv_len: a split that starts at or
    past a row's kv_len is empty and its block exits."""
    if slots <= 0:
        return 1, SPLIT_ALIGN
    want = max(_cdiv(BLOCKS_PER_SM * sm_count, max(1, B * KVH)), _cdiv(slots, SPLIT_MAX_TOKENS))
    n = max(1, min(want, _cdiv(slots, SPLIT_MIN_TOKENS)))
    split_len = _cdiv(_cdiv(slots, n), SPLIT_ALIGN) * SPLIT_ALIGN
    return _cdiv(slots, split_len), split_len


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def page_strides(name: str, pages) -> tuple:
    """(page stride, slot stride), in elements, of k or v pages (P, page,
    KVH, D) the kernel can read in place: contiguous over (KVH, D), page
    and slot strides of whole 16-byte units, a start on 16 bytes.  A view
    of a rank's KV heads of a whole cache (``models/layers.kv_head_view``)
    is such pages; so is the empty part of a split (KVH 0).  Raises
    ValueError on any other layout: the kernel copies nothing."""
    vec = 16 // pages.element_size()  # the kernel gathers 16-byte copies
    if pages.stride(3) != 1 or (pages.shape[2] > 1 and pages.stride(2) != pages.shape[3]):
        raise ValueError(f"{name} must be contiguous over (heads, head_dim); strides {pages.stride()}")
    if pages.data_ptr() % 16 or pages.stride(0) % vec or pages.stride(1) % vec:
        raise ValueError(f"{name} must start on 16 bytes with page and slot strides of whole 16-byte units; "
                         f"strides {pages.stride()}")
    return pages.stride(0), pages.stride(1)


def kv_page_strides(k_pages, v_pages) -> tuple:
    """The (page stride, slot stride) k and v pages share, each taken by
    ``page_strides``.  Every cache the models hold lays v out as k, so the
    kernel reads both at one pair of strides; raises ValueError where they
    differ."""
    ks, vs = page_strides("k_pages", k_pages), page_strides("v_pages", v_pages)
    if ks != vs:
        raise ValueError(f"k and v pages must share their page and slot strides; got {ks} and {vs}")
    return ks


def _check(q, k_pages, v_pages, block_tables, kv_len) -> None:
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError("paged_decode expects q (B,H,D) and k/v pages (P,page,KVH,D)")
    B, H, D = q.shape
    if v_pages.shape != k_pages.shape or k_pages.shape[3] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k_pages.shape)}, v {tuple(v_pages.shape)}")
    KVH = k_pages.shape[2]
    if (H % KVH) if KVH else H:  # no KV heads only with no heads (an empty part of a split)
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
    """q (B, H, D); k/v_pages (P, page, KVH, D), contiguous or a view
    ``page_strides`` takes; block_tables (B, NB) int32; kv_len (B,) int32
    -> (B, H, D) in q's dtype.  Slots at or past kv_len are masked; a row
    with kv_len = 0 gives zeros."""
    _check(q, k_pages, v_pages, block_tables, kv_len)
    return _build.run_on("paged_decode", q.device, lambda: paged_decode_ref(q, k_pages, v_pages, block_tables, kv_len),
                         lambda: _launch(q, k_pages, v_pages, block_tables, kv_len),
                         inputs=(q, k_pages, v_pages))


def _launch(q, k_pages, v_pages, block_tables, kv_len):
    global launches
    B, H, D = q.shape
    if B == 0 or H == 0:  # no sequence, or a rank's empty part of a split over heads
        return torch.empty_like(q)
    _, page, KVH, _ = k_pages.shape
    G = H // KVH
    NB = block_tables.shape[1]
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {D}")
    for name, t in (("q", q), ("block_tables", block_tables), ("kv_len", kv_len)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    strides = (ctypes.c_int64 * 4)(*kv_page_strides(k_pages, v_pages) * 2)
    lib = _build.bind("decode_attention", _SIGNATURES)
    if lib.paged_decode_smem_bytes(DTYPE_CODES[q.dtype], G, D) > SMEM_LIMIT:
        raise ValueError(f"G={G}, D={D} needs more shared memory than one block has")
    o = torch.empty_like(q)
    n_splits, split_len = split_plan(B, KVH, NB * page, _build.sm_count(q.device))
    part_ml = torch.empty((B, KVH, n_splits, G, 2), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((B, KVH, n_splits, G, D), dtype=torch.float32, device=q.device)
    _build.call(lib, "paged_decode", "paged_decode_fwd", q.device,
                DTYPE_CODES[q.dtype], q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_tables.data_ptr(), kv_len.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(),
                o.data_ptr(), B, KVH, G, D, page, NB, n_splits, split_len, strides, float(D**-0.5))
    launches += 1
    return o


def design(dtype: torch.dtype) -> str:
    """The split kernel the library runs for ``dtype``, as it reports it."""
    return _build.bind("decode_attention", _SIGNATURES).paged_decode_design(DTYPE_CODES[dtype]).decode()


_SIGNATURES = {
    "paged_decode_fwd": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_void_p,
    ]),
    "paged_decode_smem_bytes": (ctypes.c_size_t, [ctypes.c_int, ctypes.c_int, ctypes.c_int]),
    "paged_decode_design": (ctypes.c_char_p, [ctypes.c_int]),
}


__all__ = ["design", "kv_page_strides", "page_strides", "paged_decode", "paged_decode_ref", "split_plan"]
