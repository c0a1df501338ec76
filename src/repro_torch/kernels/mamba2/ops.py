"""Wrappers of the Mamba-2 SSD kernel.

``ssd`` keeps the reference op's contract (``kernels/mamba2/ops.py``):
chunk 64 by default, shrunk to S when S divides it.  ``ssd_chunked`` is the
model's scan (``models/ssm.py::mamba2_ssd_chunked``) at its chunk of 256;
the kernel forms every chunk's local state in parallel, passes the states
from chunk to chunk in one elementwise pass, then forms the outputs in
64-row tiles, so no 256 x 256 matrix is ever held.  Its f32 workspace
(each chunk's state and cumulative log-decay) comes from PyTorch's
allocator.  Both take the model's layout, x (B,S,H,P), B/C (B,S,N), a/dt
(B,S,H), through strides: the model's views into its conv output are read
in place, and the kernel masks the ragged last chunk itself (steps past S
read as a = 1, dt = 0, the reference's padding).

A CUDA tensor launches ``csrc/mamba2.cu``; a CPU tensor takes the plain
version in ``ref.py``; any other device raises.  There is no fallback from
the kernel to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import ssd_chunked_plain, ssd_ref

# kernel launches since the last reset (``repro_torch.kernels.reset_launch_counts``)
launches = 0

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_PN = 64       # head size P and state size N the kernel's buffers hold
MAX_CHUNK = 256   # chunk length the kernel takes


def ssd(x, Bm, Cm, a, dt, state, *, chunk: int = 64):
    """x (B,S,H,P); Bm/Cm (B,S,N); a/dt (B,S,H) f32; state (B,H,P,N) f32.
    Returns (y (B,S,H,P) f32, new_state (B,H,P,N) f32)."""
    S = x.shape[1] if x.dim() == 4 else 0
    c = min(chunk, S) if S and S % min(chunk, S) == 0 else chunk
    return _run(x, Bm, Cm, a, dt, state, c)


def ssd_chunked(x, Bm, Cm, a, dt, state, *, chunk: int = 256):
    """The model's chunked SSD: as ``ssd``, at a fixed chunk."""
    return _run(x, Bm, Cm, a, dt, state, chunk)


def _check(x, Bm, Cm, a, dt, state, chunk: int) -> None:
    if x.dim() != 4 or Bm.dim() != 3 or Cm.dim() != 3 or a.dim() != 3 or dt.dim() != 3:
        raise ValueError("ssd expects x (B,S,H,P), Bm/Cm (B,S,N) and a/dt (B,S,H)")
    B, S, H, P = x.shape
    N = Bm.shape[2]
    if Bm.shape[:2] != (B, S) or Cm.shape != Bm.shape or a.shape != (B, S, H) or dt.shape != a.shape:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}, "
                         f"a {tuple(a.shape)}, dt {tuple(dt.shape)}")
    if tuple(state.shape) != (B, H, P, N):
        raise ValueError(f"state must be {(B, H, P, N)}, got {tuple(state.shape)}")
    if S == 0:
        raise ValueError("ssd needs at least one step")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if not (x.dtype == Bm.dtype == Cm.dtype) or x.dtype not in DTYPE_CODES:
        raise TypeError(f"x/Bm/Cm must share one of {list(DTYPE_CODES)}, got {x.dtype}/{Bm.dtype}/{Cm.dtype}")
    devs = {t.device for t in (x, Bm, Cm, a, dt, state)}
    if len(devs) != 1:
        raise ValueError(f"all operands must be on one device, got {devs}")


def _run(x, Bm, Cm, a, dt, state, chunk: int):
    _check(x, Bm, Cm, a, dt, state, chunk)
    return _build.run_on("ssd", x.device, lambda: ssd_chunked_plain(x, Bm, Cm, a, dt, state, chunk),
                         lambda: _launch(x, Bm, Cm, a, dt, state, chunk), inputs=(x, Bm, Cm, a, dt, state))


def _launch(x, Bm, Cm, a, dt, state, chunk: int):
    global launches
    B, S, H, P = x.shape
    N = Bm.shape[2]
    if P > MAX_PN or N > MAX_PN or chunk > MAX_CHUNK:
        raise ValueError(f"the kernel takes P, N <= {MAX_PN} and chunk <= {MAX_CHUNK}, "
                         f"got P {P}, N {N}, chunk {chunk}")
    if a.dtype != torch.float32 or dt.dtype != torch.float32 or state.dtype != torch.float32:
        raise TypeError(f"a, dt and state must be float32, got {a.dtype}, {dt.dtype}, {state.dtype}")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride over its last dim; strides {t.stride()}")
    state = state.contiguous()
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    s_out = torch.empty_like(state)
    lib = _build.bind("mamba2", _SIGNATURES)
    ws = torch.empty(lib.mamba2_ssd_workspace_floats(B, S, H, P, N, chunk), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_int64 * 16)(*x.stride()[:3], *Bm.stride()[:2], *Cm.stride()[:2],
                                    *a.stride(), *dt.stride(), *y.stride()[:3])
    _build.call(lib, "mamba2", "mamba2_ssd_fwd", x.device,
                DTYPE_CODES[x.dtype], x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), a.data_ptr(),
                dt.data_ptr(), state.data_ptr(), y.data_ptr(), s_out.data_ptr(), ws.data_ptr(),
                B, S, H, P, N, chunk, strides)
    launches += 1
    return y, s_out


def design(dtype: torch.dtype, B: int, S: int, H: int, P: int, N: int, chunk: int = 256) -> str:
    """What the library runs for ``dtype`` at this shape, as it reports it:
    the product instruction, the state pass's steps, the blocks per kernel."""
    lib = _build.bind("mamba2", _SIGNATURES)
    return lib.mamba2_ssd_plan(DTYPE_CODES[dtype], B, S, H, P, N, chunk).decode()


_SIGNATURES = {
    "mamba2_ssd_workspace_floats": (ctypes.c_size_t, [ctypes.c_int] * 6),
    "mamba2_ssd_plan": (ctypes.c_char_p, [ctypes.c_int] * 7),
    "mamba2_ssd_fwd": (ctypes.c_int, [
        ctypes.c_int, *([ctypes.c_void_p] * 9),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p,
    ]),
}


__all__ = ["design", "ssd", "ssd_chunked", "ssd_ref", "ssd_chunked_plain"]
