"""Parameter-spec trees and their materialisation on an explicit device,
and the tensor-parallel context the models' splits read.

A nested dict of ``Spec`` leaves is the single source of truth for a
model's parameters; ``tree_init`` turns it into a dict of tensors with the
reference's init schemes.

The reference's sharding hook is ``constrain`` (``with_sharding_constraint``
under ``with mesh``, the identity without one): a layout, never another
function.  Its counterpart here is ``tensor_parallel(mesh)``, which the
training step and a cached forward enter: under it, with a ``model`` axis
over 1, the layers at the reference's constrain sites (``layers.py``,
``transformer.py``, ``encdec.py``) compute their rank's part of the split
(heads, the SwiGLU hidden dim, experts, the vocabulary) from views of
parameters, and of caches, every rank holds whole, and join the parts with
the two conjugate collectives below, so the loss and gradients, or the
logits and caches, are one device's.  Without the context, or at a
``model`` size of 1, every layer runs its one-device code unchanged.

The reference's sequence sharding (``cfg.seq_shard``) has its
counterpart in ``sequence_split``: where ``splits_sequence`` holds, the
dense and moe forwards hold only the rank's ``S / model`` rows of the
residual stream between blocks, and the splits' entries and exits become
an all-gather and a reduce-scatter over the sequence (``enter_split``,
``leave_split``).  The function is the same; what a rank keeps, and the
kinds of collective, change.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Spec:
    """Declarative parameter leaf: shape + dtype + init scheme."""

    shape: Tuple[int, ...]
    dtype: Any = torch.bfloat16
    init: str = "normal"  # normal | zeros | ones | small
    scale: float = 1.0


_LEAF = object()  # a leaf's place in a tree definition


def tree_flatten(tree, is_leaf=None) -> Tuple[List, Any]:
    """(leaves, treedef) in ``jax.tree.flatten``'s order: dict keys sorted
    at every level; ``None`` is an empty subtree, as in JAX; a subtree for
    which ``is_leaf`` is true is one leaf.  The optimizer walks its leaves
    in this order and a checkpoint numbers them so, which is what lets
    either package read the other's checkpoints."""
    if tree is None:
        return [], None
    if isinstance(tree, dict) and not (is_leaf is not None and is_leaf(tree)):
        leaves, defs = [], {}
        for k in sorted(tree):
            sub, defs[k] = tree_flatten(tree[k], is_leaf)
            leaves += sub
        return leaves, defs
    return [tree], _LEAF


def tree_unflatten(treedef, leaves) -> Any:
    """Inverse of ``tree_flatten``: ``leaves`` in its order."""
    it = iter(leaves)

    def build(d):
        if d is _LEAF:
            return next(it)
        if d is None:
            return None
        return {k: build(v) for k, v in d.items()}

    out = build(treedef)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the tree definition has places")
    return out


def tree_leaves(tree) -> List:
    """Leaves in sorted-key order (the order ``jax.tree.flatten`` uses)."""
    return tree_flatten(tree)[0]


def _generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def init_leaf(s: Spec, device, seed: int) -> torch.Tensor:
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=s.dtype, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=s.dtype, device=device)
    fan_in = s.shape[-2] if len(s.shape) >= 2 else max(1, s.shape[-1])
    std = s.scale / np.sqrt(fan_in)
    if s.init == "small":
        std *= 0.1
    gen = _generator(device, seed)
    out = torch.empty(s.shape, dtype=s.dtype, device=device)
    # a stacked leaf is drawn one layer at a time: the f32 draw of a whole
    # (L, D, F) stack would need twice the bf16 result's memory again
    rows = out if len(s.shape) >= 3 else out[None]
    for r in rows:
        r.copy_(torch.randn(r.shape, generator=gen, dtype=torch.float32, device=device) * std)
    return out


def tree_init(template, seed: int = 0, device="cuda") -> Dict:
    """Spec tree -> dict of tensors on ``device``.  Leaf i (in sorted-key
    order) is drawn from a generator seeded with ``seed * 1_000_003 + i``.
    The numbers differ from JAX's for the same seed; tests that compare
    the two packages convert JAX's params (``models.convert``)."""
    counter = iter(range(len(tree_leaves(template))))

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(tree[k]) for k in sorted(tree)}
        return init_leaf(tree, device, seed * 1_000_003 + next(counter))

    return build(template)


def resolve_device(device) -> torch.device:
    """The device a run asked for; a CUDA device that is not there raises
    rather than falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' asked for, but no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return dev


def count_params(tree) -> int:
    return sum(int(t.numel()) for t in tree_leaves(tree))


# ------------------------------------------------------ tensor parallelism
# the reference's axis names: batch over (pod, data), the splits over model
BATCH_AXES = ("pod", "data")
MODEL_AXIS = "model"


@dataclass(frozen=True)
class MeshAxes:
    """What the models read of the mesh a training step runs under: the
    ``model`` axis's group, this rank's coordinate on it and its size, and
    the batch axes' groups and the product of their sizes."""

    model_group: Any
    model_rank: int
    model_size: int
    batch_groups: Tuple[Any, ...]
    batch_size: int
    seq_split: bool = False  # the residual stream holds this rank's S / model rows (``sequence_split``)


_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


def _mesh_axes(mesh) -> MeshAxes:
    """A ``DeviceMesh``'s groups and this rank's coordinate, by axis name."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    batch = [a for a in BATCH_AXES if a in sizes]
    model = sizes.get(MODEL_AXIS, 1)
    return MeshAxes(
        model_group=mesh.get_group(MODEL_AXIS) if model > 1 else None,
        model_rank=mesh.get_local_rank(MODEL_AXIS) if model > 1 else 0,
        model_size=model,
        batch_groups=tuple(mesh.get_group(a) for a in batch if sizes[a] > 1),
        batch_size=int(np.prod([sizes[a] for a in batch])),
    )


@contextlib.contextmanager
def tensor_parallel(mesh):
    """``with tensor_parallel(mesh):`` runs the models as the reference runs
    them under ``with mesh``: split over ``model`` at the constrain sites,
    and moe's balance term taken over the batch the batch axes hold.
    ``mesh=None`` enters nothing."""
    token = _MESH.set(None if mesh is None else _mesh_axes(mesh))
    try:
        yield
    finally:
        _MESH.reset(token)


def current_tp() -> Optional[MeshAxes]:
    """The active context when its ``model`` axis is over 1, else None:
    the constrain sites split only then."""
    axes = _MESH.get()
    return axes if axes is not None and axes.model_size > 1 else None


def under_current_mesh(fn):
    """``fn`` bound to the context active now, for code that runs it later
    on another thread (activation checkpointing recomputes a block during
    the backward, which runs on the autograd engine's device threads)."""
    axes = _MESH.get()
    if axes is None:
        return fn

    @functools.wraps(fn)
    def run(*args, **kwargs):
        token = _MESH.set(axes)
        try:
            return fn(*args, **kwargs)
        finally:
            _MESH.reset(token)

    return run


def split_range(n: int, parts: int, index: int) -> Tuple[int, int]:
    """[lo, hi) of part ``index`` of ``n`` items cut into ``parts`` runs in
    order, the first ``n % parts`` one longer (an uneven dim takes uneven
    slices).  Where ``n < parts``, parts ``0 .. n-1`` take one item each and
    the rest an empty range: every consumer runs on an empty part, whose
    contribution to ``reduce_from_model`` is zero.  The largest part is
    ``ceil(n / parts)``, what the reference's GSPMD padding gives a device."""
    q, r = divmod(n, parts)
    lo = index * q + min(index, r)
    return lo, lo + q + (index < r)


def grouped_head_split(kvh: int, g: int, model: int) -> str:
    """Which dim of the grouped-head layout (..., KVH, G, ...) attention
    splits over ``model`` (the reference's ``_grouped_head_axes``): "g"
    when ``model`` divides the groups, else "kvh" when it divides the KV
    heads, else the larger of the two ("kvh" on a tie), in uneven slices
    where the reference's GSPMD pads."""
    if g % model == 0:
        return "g"
    if kvh % model == 0:
        return "kvh"
    return "kvh" if kvh >= g else "g"


def _sum_f32(t, groups):
    """``t`` summed over the ranks of ``groups`` (one after another) in
    f32, rounded once to ``t``'s dtype; ``t`` itself is not written."""
    acc = t.to(torch.float32, copy=True)
    for g in groups:
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=g)
    return acc.to(t.dtype)


class _Collective(torch.autograd.Function):
    """The identity or a sum over ``groups`` forward (``fwd``), the
    identity or a sum backward (``bwd``)."""

    @staticmethod
    def forward(ctx, x, groups, fwd: bool, bwd: bool):
        ctx.groups, ctx.bwd = groups, bwd
        return _sum_f32(x, groups) if fwd else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (_sum_f32(g, ctx.groups) if ctx.bwd else g), None, None, None


def copy_to_model(x, tp: MeshAxes):
    """Where a replicated tensor enters a split: the identity forward; the
    gradient, which each model rank holds only for its part of the split,
    summed over ``model`` backward."""
    return _Collective.apply(x, (tp.model_group,), False, True)


def reduce_from_model(x, tp: MeshAxes):
    """Where a split's partial sums leave it: summed over ``model`` forward,
    the identity backward.  Each rank's partial (its product, in the
    activation's dtype) crosses the group in f32, and the sum is rounded
    once to ``x``'s dtype, as the step's gradient mean is.  The loss is the
    same on every model rank, so its gradient already is: a sum here
    would multiply it by the ``model`` size."""
    return _Collective.apply(x, (tp.model_group,), True, False)


def mean_over_batch(t):
    """The mean of ``t`` over the batch axes' ranks under the active
    context (each rank holding as many rows), ``t`` itself without one.
    Backward, the gradient is summed over the same ranks: the step then
    takes the mean of the ranks' gradients, so a term built on this mean
    counts once, as in the reference's step over the global batch."""
    axes = _MESH.get()
    if axes is None or not axes.batch_groups:
        return t
    return _Collective.apply(t, axes.batch_groups, True, True) / axes.batch_size


# ------------------------------------------------------ sequence sharding
SEQ_SPLIT_FAMILIES = ("dense", "moe")  # the reference constrains the stream in their blocks only


def splits_sequence(cfg, S: int, model_size: int, cached: bool) -> bool:
    """Whether a forward of ``S`` tokens holds the residual stream split
    over ``model`` on the sequence: the reference's rule
    (``models/transformer.py:171``: ``seq_shard`` on, ``model`` over 1
    and dividing S) in the families whose blocks it constrains, and, in
    the port, no cache (the reference sets the flag only in its train
    steps, so its cached steps never see it)."""
    return (cfg.seq_shard and cfg.family in SEQ_SPLIT_FAMILIES and model_size > 1 and S % model_size == 0
            and not cached)


@contextlib.contextmanager
def sequence_split(on: bool):
    """``with sequence_split(True):`` marks the active context's residual
    stream as split over sequence, so the layers enter and leave their
    splits through ``enter_split`` and ``leave_split``, and parameters
    applied to the rank's rows through ``on_rows``; ``False`` enters
    nothing.  Activation checkpointing's recompute sees the mark too
    (``under_current_mesh``)."""
    axes = current_tp()
    if not on or axes is None:
        yield
        return
    token = _MESH.set(dataclasses.replace(axes, seq_split=True))
    try:
        yield
    finally:
        _MESH.reset(token)


def seq_rows(t, tp: MeshAxes):
    """This model rank's rows of ``t``'s dim 1 (the sequence), as a view:
    the ``model_rank``-th of ``model_size`` equal runs."""
    n = t.shape[1] // tp.model_size
    return t.narrow(1, tp.model_rank * n, n)


def _gather_seq(t, tp: MeshAxes):
    """(B, n, ...) on each model rank -> (B, model·n, ...), the ranks' rows
    in rank order, exact in ``t``'s dtype."""
    out = t.new_empty((tp.model_size * t.shape[0],) + tuple(t.shape[1:]))  # the ranks' tensors end to end
    dist.all_gather_into_tensor(out, t.contiguous(), group=tp.model_group)
    return out.unflatten(0, (tp.model_size, -1)).movedim(0, 1).flatten(1, 2)


def _reduce_scatter_seq(t, tp: MeshAxes):
    """(B, S, ...) partial sums on each model rank -> this rank's rows
    (``seq_rows``) of their sum over ``model``, taken in f32 and rounded
    once to ``t``'s dtype."""
    parts = t.unflatten(1, (tp.model_size, -1)).movedim(1, 0)  # rank r's rows r-th
    parts = parts.to(torch.float32, memory_format=torch.contiguous_format)  # one copy
    out = parts.new_empty(parts.shape[1:])
    dist.reduce_scatter_tensor(out, parts.flatten(0, 1), op=dist.ReduceOp.SUM, group=tp.model_group)
    return out.to(t.dtype)


class _SeqGather(torch.autograd.Function):
    """Where the split stream enters a split over ``model``: all-gathered
    forward, exact in the activation's dtype (a gather moves values, it
    rounds nothing).  Backward, each rank holds the gradient only for its
    part of the split, over every row: the parts are summed and scattered
    back to their rows (``_reduce_scatter_seq``), in f32 and rounded once,
    as ``reduce_from_model`` rounds its sum."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _gather_seq(x, tp)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_seq(g, ctx.tp), None


class _SeqReduceScatter(torch.autograd.Function):
    """Where a split's partial sums leave it into the split stream: summed
    over ``model`` and scattered to the ranks' rows forward, in f32 and
    rounded once to the activation's dtype (each rank's partial is a
    product in that dtype; one device rounds the whole product once).
    Backward, each rank's rows of the gradient are the whole gradient of
    its output rows: all-gathered, exact."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _reduce_scatter_seq(x, tp)

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g, ctx.tp), None


class _SeqSlice(torch.autograd.Function):
    """Where a tensor every model rank holds whole becomes the split stream
    (after the embedding): this rank's rows forward, in a storage of their
    own, so nothing keeps the whole tensor alive.  Backward, the rows'
    gradients are all-gathered, exact, so the whole tensor's gradient
    (and the embedding table's, behind it) is whole on every rank: the
    table needs no sum over ``model``, which would move far more than a
    (B, S, D) gradient."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return seq_rows(x, tp).clone()

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g, ctx.tp), None


def split_rows(x, tp: MeshAxes):
    """A whole tensor -> this rank's rows of the split stream (``_SeqSlice``)."""
    return _SeqSlice.apply(x, tp)


def gather_rows(x, tp: MeshAxes):
    """The split stream's rows -> every row (``_SeqGather``; an integer
    tensor is gathered without autograd)."""
    return _SeqGather.apply(x, tp) if x.is_floating_point() else _gather_seq(x, tp)


def enter_split(x, tp: MeshAxes):
    """Where an activation enters a split over ``model``: ``gather_rows``
    while the stream is split over sequence, else ``copy_to_model``."""
    return gather_rows(x, tp) if tp.seq_split else copy_to_model(x, tp)


def leave_split(x, tp: MeshAxes):
    """Where a split's partial sums leave it: reduce-scattered to the
    rank's rows (``_SeqReduceScatter``) while the stream is split over
    sequence, else ``reduce_from_model``."""
    return _SeqReduceScatter.apply(x, tp) if tp.seq_split else reduce_from_model(x, tp)


def on_rows(w):
    """A parameter the rules keep whole that acts on the split stream's
    rows (a norm scale, a down-projection, the router): through
    ``copy_to_model`` while the stream is split over sequence, so its
    gradient, each rank's sum over its rows, is summed over ``model``
    inside the graph and comes out whole on every rank, as for any
    parameter ``sharding.model_partial`` leaves out; ``w`` itself
    otherwise."""
    tp = current_tp()
    return copy_to_model(w, tp) if tp is not None and tp.seq_split else w


def mean_over_seq(t):
    """The mean over the model ranks of ``t``, a mean over this rank's
    rows of the split stream, while it is split (each rank holds as many
    rows): the mean over every row; ``t`` itself otherwise.  Summed over
    ``model`` forward, the identity backward (``reduce_from_model``): the
    term built on it is the same on every model rank, so its gradient
    already is."""
    tp = current_tp()
    if tp is None or not tp.seq_split:
        return t
    return reduce_from_model(t, tp) / tp.model_size
