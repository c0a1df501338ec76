"""Wrappers of the fused AdamW kernels: one op per leaf and kernel.

``sq_norms(grads)`` gives each leaf's sum of squares in an f64 device
array (``sq_norm``, one launch a leaf); ``factored_stats`` folds a leaf's
row and column means of g² into vr and vc and returns the rank-1
divisor; ``adamw_update`` updates p, m and v (or p and m, reading vr and
vc) in place.  Each reads the step's ``scalars`` (clip scale, lr, 1 - b1^t,
1 - b2^t: a (4,) f32 tensor on the leaf's device), so nothing is read
from the host and the step can be captured as a CUDA graph.

Each op is a ``torch.library`` custom op (``repro_torch::adamw_*``) that
writes its arguments in place.  A CUDA tensor launches ``csrc/adamw.cu``;
a CPU tensor takes the plain version in ``ref.py``; ``meta`` (the dry
run) runs nothing, and the cost counter (``launch/cost.py``) charges the
op what the kernel moves: each tensor argument read once, each argument
it writes written once.  Any other device raises.  There is no fallback
from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import torch

from .. import _build
from .ref import adamw_update_ref, factored_stats_ref, sq_norm_ref

# kernel launches since the last reset (``repro_torch.kernels.reset_launch_counts``)
sq_norm_launches = 0
update_launches = 0
factored_launches = 0

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # p and g; m too
THREADS = 256        # a block (THREADS in adamw.cu)
VEC = 8              # elements a thread moves at once: 16 bytes of bf16 (VEC in adamw.cu)
ROWS = 128           # factored_stats: rows of a tile (ROWS in adamw.cu)
COLS = 32 * VEC      # factored_stats: columns of a tile (COLS in adamw.cu)
BLOCKS_PER_SM = 4    # sq_norm and adamw_update: the grid-stride loop's blocks, at most, an SM
VECTOR_BYTES = 16
MAX_GRID_YZ = 65535


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def grid_blocks(n: int, vector: bool, sm_count: int) -> int:
    """Blocks of a flat pass over ``n`` elements (VEC a thread where
    ``vector``, else one): one a THREADS items, at most BLOCKS_PER_SM an
    SM; at least one."""
    items = n // VEC if vector else n
    return max(1, min(_cdiv(items, THREADS), BLOCKS_PER_SM * sm_count))


def factored_shape(shape) -> tuple:
    """(L, R, C) of a factored leaf: the leading dims' product, then the
    last two."""
    L = 1
    for d in shape[:-2]:
        L *= d
    return L, shape[-2], shape[-1]


def _check_scalars(scalars, device) -> None:
    if scalars.dtype != torch.float32 or scalars.shape != (4,) or not scalars.is_contiguous() or \
            scalars.device != device:
        raise ValueError(f"the step's scalars are a contiguous (4,) float32 tensor on {device}: clip scale, lr, "
                         f"1 - b1^t, 1 - b2^t; got {tuple(scalars.shape)} {scalars.dtype} on {scalars.device}")


def _aligned(*ts) -> bool:
    return all(t is None or t.data_ptr() % VECTOR_BYTES == 0 for t in ts)


# ----------------------------------------------------------- custom ops
@torch.library.custom_op("repro_torch::adamw_sq_norm", mutates_args=("out",), device_types=("cpu", "cuda"))
def _sq_norm_op(g: torch.Tensor, out: torch.Tensor, index: int) -> None:
    _build.run_on("sq_norm", g.device, lambda: out[index].copy_(sq_norm_ref(g)),
                  lambda: _launch_sq_norm(g, out, index), inputs=(g,))


@_sq_norm_op.register_fake
def _(g, out, index):
    return None


@torch.library.custom_op("repro_torch::adamw_factored_stats", mutates_args=("vr", "vc", "denom"),
                         device_types=("cpu", "cuda"))
def _factored_op(g: torch.Tensor, vr: torch.Tensor, vc: torch.Tensor, denom: torch.Tensor, scalars: torch.Tensor,
                 b2: float) -> None:
    _build.run_on("factored_stats", g.device, lambda: factored_stats_ref(g, vr, vc, denom, scalars, b2),
                  lambda: _launch_factored(g, vr, vc, denom, scalars, b2), inputs=(g,))


@_factored_op.register_fake
def _(g, vr, vc, denom, scalars, b2):
    return None


@torch.library.custom_op("repro_torch::adamw_update", mutates_args=("p", "m", "v"), device_types=("cpu", "cuda"))
def _update_op(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: Optional[torch.Tensor],
               vr: Optional[torch.Tensor], vc: Optional[torch.Tensor], denom: Optional[torch.Tensor],
               scalars: torch.Tensor, b1: float, b2: float, eps: float, wd: float, decay: bool) -> None:
    _build.run_on("adamw_update", p.device,
                  lambda: adamw_update_ref(p, g, m, v, vr, vc, denom, scalars, b1, b2, eps, wd, decay),
                  lambda: _launch_update(p, g, m, v, vr, vc, denom, scalars, b1, b2, eps, wd, decay), inputs=(p, g))


@_update_op.register_fake
def _(p, g, m, v, vr, vc, denom, scalars, b1, b2, eps, wd, decay):
    return None


# ------------------------------------------------------------- wrappers
def _check_leaf(what: str, t, dtypes=DTYPE_CODES) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{what} takes {list(dtypes)}, got {t.dtype}")


def sq_norms(grads: List[torch.Tensor]) -> torch.Tensor:
    """Each leaf's sum of squares, summed in f64 from the exact squares: a
    (len(grads),) f64 tensor on the leaves' device."""
    if not grads:
        raise ValueError("sq_norms needs at least one leaf")
    device = grads[0].device
    out = torch.empty(len(grads), dtype=torch.float64, device=device)
    for i, g in enumerate(grads):
        _check_leaf("sq_norm", g)
        if g.device != device:
            raise ValueError(f"sq_norms needs the leaves of one device, got {device} and {g.device}")
        torch.ops.repro_torch.adamw_sq_norm(g, out, i)
    return out


def factored_stats(g, vr, vc, scalars, b2: float):
    """vr (..., R) and vc (..., C) of a factored leaf g (..., R, C) take the
    row and column means of the clipped g², in place; returns denom (...),
    f32: max(mean(vc), 1e-30)."""
    _check_leaf("factored_stats", g)
    if g.dim() < 2 or tuple(vr.shape) != tuple(g.shape[:-1]) or tuple(vc.shape) != tuple(g.shape[:-2] + g.shape[-1:]):
        raise ValueError(f"factored_stats: g {tuple(g.shape)}, vr {tuple(vr.shape)}, vc {tuple(vc.shape)}")
    if vr.dtype != torch.float32 or vc.dtype != torch.float32:
        raise TypeError("factored_stats keeps vr and vc in float32")
    denom = torch.empty(g.shape[:-2], dtype=torch.float32, device=g.device)
    torch.ops.repro_torch.adamw_factored_stats(g, vr, vc, denom, scalars, b2)
    return denom


def adamw_update(p, g, m, v, scalars, *, b1: float, b2: float, eps: float, weight_decay: float, vr=None, vc=None,
                 denom=None) -> None:
    """One AdamW step of leaf ``p`` with gradient ``g`` (p's dtype), in
    place on p, m and v.  ``v`` None: the factored second moment, from the
    vr, vc and denom that ``factored_stats`` left.  Weight decay where
    p.ndim >= 2, as the reference decays."""
    _check_leaf("adamw_update", p)
    _check_leaf("adamw_update's m", m)
    if g.dtype != p.dtype or g.shape != p.shape or m.shape != p.shape:
        raise ValueError(f"adamw_update: p {tuple(p.shape)} {p.dtype}, g {tuple(g.shape)} {g.dtype}, "
                         f"m {tuple(m.shape)}")
    if (v is None) == (denom is None) or (v is not None and (v.shape != p.shape or v.dtype != torch.float32)):
        raise ValueError("adamw_update takes v (p's shape, float32), or vr, vc and denom from factored_stats")
    torch.ops.repro_torch.adamw_update(p, g, m, v, vr, vc, denom, scalars, b1, b2, eps, weight_decay, p.dim() >= 2)


# ------------------------------------------------------------- launches
def _launch_sq_norm(g, out, index: int) -> None:
    global sq_norm_launches
    gc = g if g.is_contiguous() else g.contiguous()
    n = gc.numel()
    vector = _aligned(gc)
    blocks = grid_blocks(n, vector, _build.sm_count(g.device))
    ws = torch.empty(blocks, dtype=torch.float64, device=g.device)
    lib = _build.bind("adamw", _SIGNATURES)
    _build.call(lib, "adamw", "adamw_sq_norm", g.device, DTYPE_CODES[g.dtype], gc.data_ptr(), ws.data_ptr(),
                out.data_ptr(), index, n, blocks, int(vector))
    sq_norm_launches += 1


def _launch_factored(g, vr, vc, denom, scalars, b2: float) -> None:
    global factored_launches
    _check_scalars(scalars, g.device)
    if not (vr.is_contiguous() and vc.is_contiguous()):
        raise ValueError("factored_stats writes vr and vc in place: they must be contiguous")
    gc = g if g.is_contiguous() else g.contiguous()
    L, R, C = factored_shape(tuple(g.shape))
    ctiles, rslabs, cblocks = _cdiv(C, COLS), _cdiv(R, ROWS), _cdiv(C, THREADS)
    if g.numel() == 0 or rslabs > MAX_GRID_YZ or L > MAX_GRID_YZ:
        raise ValueError(f"factored_stats: no launch for a leaf of shape {tuple(g.shape)}")
    row_ws = torch.empty(L * ctiles * R, dtype=torch.float64, device=g.device)
    col_ws = torch.empty(L * rslabs * C, dtype=torch.float64, device=g.device)
    dpart = torch.empty(L * cblocks, dtype=torch.float64, device=g.device)
    vector = _aligned(gc) and C % VEC == 0
    lib = _build.bind("adamw", _SIGNATURES)
    _build.call(lib, "adamw", "adamw_factored_stats", g.device, DTYPE_CODES[g.dtype], gc.data_ptr(),
                scalars.data_ptr(), vr.data_ptr(), vc.data_ptr(), denom.data_ptr(), row_ws.data_ptr(),
                col_ws.data_ptr(), dpart.data_ptr(), b2, 1 - b2, L, R, C, int(vector))
    factored_launches += 1


def _launch_update(p, g, m, v, vr, vc, denom, scalars, b1, b2, eps, wd, decay) -> None:
    global update_launches
    _check_scalars(scalars, p.device)
    if not all(t.is_contiguous() for t in (p, m, v, vr, vc, denom) if t is not None):
        raise ValueError("adamw_update writes p, m and v in place: p, m, v (or vr, vc, denom) must be contiguous")
    gc = g if g.is_contiguous() else g.contiguous()
    n = p.numel()
    factored = v is None
    L, R, C = factored_shape(tuple(p.shape)) if factored else (1, 1, 1)
    vector = _aligned(p, gc, m, v) and (not factored or C % VEC == 0)
    blocks = grid_blocks(n, vector, _build.sm_count(p.device))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _build.bind("adamw", _SIGNATURES)
    _build.call(lib, "adamw", "adamw_update", p.device, DTYPE_CODES[p.dtype], DTYPE_CODES[m.dtype], int(factored),
                p.data_ptr(), gc.data_ptr(), m.data_ptr(), ptr(v), ptr(vr), ptr(vc), ptr(denom), scalars.data_ptr(),
                b1, 1 - b1, b2, 1 - b2, eps, wd, int(decay), n, R, C, blocks, int(vector))
    update_launches += 1


_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    "adamw_sq_norm": (ctypes.c_int, [_I, _P, _P, _P, _I64, _I64, _I, _I, _P]),
    "adamw_factored_stats": (ctypes.c_int, [_I, _P, _P, _P, _P, _P, _P, _P, _P, _F, _F, _I64, _I64, _I64, _I, _P]),
    "adamw_update": (ctypes.c_int, [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _F, _F, _F, _F, _F, _F, _I,
                                    _I64, _I64, _I64, _I, _I, _P]),
}


__all__ = ["sq_norms", "factored_stats", "adamw_update", "sq_norm_ref", "factored_stats_ref", "adamw_update_ref"]
