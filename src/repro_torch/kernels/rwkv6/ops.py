"""Wrappers of the RWKV6 WKV kernel, in two layouts.

``wkv`` keeps the reference op's contract (``kernels/rwkv6/ops.py``):
(B, H, S, N) tensors, chunk 32 by default, shrunk to S when S divides it.
``wkv_model`` is the model's scan (``models/ssm.py::wkv_chunked``):
(B, S, H, N) tensors and a fixed chunk of 16, never shrunk, since the
chunk sets the log-decay clamp and with it the model's output.

Both hand the kernel strides, so neither layout is transposed or copied,
and the kernel masks the ragged last chunk itself (steps past S read as
r = k = v = 0, w = 1, the reference's padding).  The kernel passes states
between groups of chunks; its f32 workspace (per-chunk records, the
groups' states and decays) comes from PyTorch's allocator.  A CUDA tensor
launches ``csrc/rwkv6.cu``; a CPU tensor takes the plain version in ``ref.py``; any
other device raises.  There is no fallback from the kernel to the plain
version.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import wkv_chunked_plain, wkv_ref

# kernel launches since the last reset (``repro_torch.kernels.reset_launch_counts``)
launches = 0

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_N = 64      # head size the kernel's shared-memory buffers hold
MAX_CHUNK = 64  # chunk length the kernel takes


def wkv(r, k, v, w, u, state, *, chunk: int = 32):
    """r/k/v/w (B, H, S, N); u (H, N); state (B, H, N, N) f32.
    Returns (y (B, H, S, N) f32, new_state (B, H, N, N) f32)."""
    S = r.shape[2] if r.dim() == 4 else 0
    c = min(chunk, S) if S and S % min(chunk, S) == 0 else chunk
    y, s = _run(*(t.transpose(1, 2) for t in (r, k, v, w)), u, state, c)
    return y.transpose(1, 2), s


def wkv_model(r, k, v, w, u, state, *, chunk: int = 16):
    """r/k/v/w (B, S, H, N); u (H, N); state (B, H, N, N) f32.
    Returns (y (B, S, H, N) f32, new_state (B, H, N, N) f32)."""
    return _run(r, k, v, w, u, state, chunk)


def _check(r, k, v, w, u, state, chunk: int) -> None:
    if any(t.dim() != 4 for t in (r, k, v, w)):
        raise ValueError("wkv expects r/k/v/w of rank 4")
    B, S, H, N = r.shape
    if k.shape != r.shape or v.shape != r.shape or w.shape != r.shape:
        raise ValueError(f"shape mismatch: r {tuple(r.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, w {tuple(w.shape)}")
    if tuple(u.shape) != (H, N) or tuple(state.shape) != (B, H, N, N):
        raise ValueError(f"u must be {(H, N)} and state {(B, H, N, N)}, got "
                         f"{tuple(u.shape)} and {tuple(state.shape)}")
    if S == 0:
        raise ValueError("wkv needs at least one step")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if not (r.dtype == k.dtype == v.dtype) or r.dtype not in DTYPE_CODES:
        raise TypeError(f"r/k/v must share one of {list(DTYPE_CODES)}, got {r.dtype}/{k.dtype}/{v.dtype}")
    devs = {t.device for t in (r, k, v, w, u, state)}
    if len(devs) != 1:
        raise ValueError(f"all operands must be on one device, got {devs}")


def _run(r, k, v, w, u, state, chunk: int):
    _check(r, k, v, w, u, state, chunk)
    return _build.run_on("wkv", r.device, lambda: wkv_chunked_plain(r, k, v, w, u, state, chunk),
                         lambda: _launch(r, k, v, w, u, state, chunk), inputs=(r, k, v, w, u, state))


def _launch(r, k, v, w, u, state, chunk: int):
    global launches
    B, S, H, N = r.shape
    if N > MAX_N or chunk > MAX_CHUNK:
        raise ValueError(f"the kernel takes N <= {MAX_N} and chunk <= {MAX_CHUNK}, got N {N}, chunk {chunk}")
    if w.dtype != torch.float32 or u.dtype != torch.float32 or state.dtype != torch.float32:
        raise TypeError(f"w, u and state must be float32, got {w.dtype}, {u.dtype}, {state.dtype}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have unit stride over N; strides {t.stride()}")
    u, state = u.contiguous(), state.contiguous()
    y = torch.empty((B, S, H, N), dtype=torch.float32, device=r.device)
    s_out = torch.empty_like(state)
    lib = _build.bind("rwkv6", _SIGNATURES)
    ws = torch.empty(lib.rwkv6_wkv_workspace_floats(B, H, S, N, chunk), dtype=torch.float32, device=r.device)
    strides = (ctypes.c_int64 * 15)(*(x for t in (r, k, v, w, y) for x in t.stride()[:3]))
    _build.call(lib, "rwkv6", "rwkv6_wkv_fwd", r.device,
                DTYPE_CODES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), state.data_ptr(), y.data_ptr(), s_out.data_ptr(), ws.data_ptr(),
                B, H, S, N, chunk, strides)
    launches += 1
    return y, s_out


def design(dtype: torch.dtype, B: int, H: int, S: int, N: int, chunk: int = 16) -> str:
    """What the library runs for ``dtype`` at this shape, as it reports it:
    the product instruction, the chunks per state group, the blocks per kernel."""
    lib = _build.bind("rwkv6", _SIGNATURES)
    return lib.rwkv6_wkv_plan(DTYPE_CODES[dtype], B, H, S, N, chunk).decode()


_SIGNATURES = {
    "rwkv6_wkv_workspace_floats": (ctypes.c_size_t, [ctypes.c_int] * 5),
    "rwkv6_wkv_plan": (ctypes.c_char_p, [ctypes.c_int] * 6),
    "rwkv6_wkv_fwd": (ctypes.c_int, [
        ctypes.c_int, *([ctypes.c_void_p] * 9),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p,
    ]),
}


__all__ = ["design", "wkv", "wkv_model", "wkv_ref", "wkv_chunked_plain"]
