"""Per-op cost counter: FLOPs, bytes, collectives and peak live memory of
a step, counted at the dispatcher while the step runs, usually on ``meta``
tensors (shapes and dtypes, no storage, no device).

This is the role of the reference's ``launch/hlocost.py``, which walks
the XLA HLO a compiled step lowers to.  The port lowers to nothing: its
steps are eager PyTorch, so the counter reads the aten ops the step
dispatches, each one as it runs (a layer loop of ten layers dispatches
ten times, where hlocost multiplies a while body by its trip count).

Conventions, per op:

  FLOPs       hlocost's (its docstring): a matmul-like op (mm, bmm,
              addmm, baddbmm, convolutions: ``torch.utils.flop_counter``'s
              registry) 2 x out x K; an elementwise op (aten's
              ``pointwise`` tag) 1 per output element; a reduction
              (aten's ``reduction`` tag) 1 per input element; a softmax
              and its backward 5 per element (max, subtract, exp, sum,
              divide, as XLA lowers it).  Views, reshapes, copies,
              casts, creation and metadata ops count none.
  bytes       each op's inputs plus its outputs: the traffic of eager
              PyTorch, one kernel an op, with no fusion.  That is not
              hlocost's figure, which counts the operands of XLA's
              fusions only.  A gather (an index, ``index_select``,
              ``gather``, ``embedding``) counts the rows it reads and
              writes and its index, not the table; an in-place scatter
              (``index_copy_``, ``index_put_``, ``scatter_``...) the rows
              it reads and writes; ``copy_`` its source and destination
              once each; views and metadata ops nothing.
  fused ops   the port's own (``repro_torch::*``, the fused AdamW of
              ``kernels/adamw``), which write their arguments in place and
              return nothing: each tensor argument read once, each argument
              the op's schema marks written written once, the traffic of
              its kernel; 1 FLOP per element of its first argument, as one
              elementwise op.
  collectives by kind (all-reduce, all-gather, reduce-scatter,
              all-to-all, send/recv, broadcast), their operand bytes and
              counts, by the mesh axis of their group (``axes``), both
              (bytes by axis and kind), and the
              share whose group spans more than one host
              (``cards_per_host``).  ``torch.distributed``'s calls reach
              the dispatcher as c10d ops, so every collective of the
              port's steps is counted here, ``models.common._sum_f32`` and
              ``training.loop._mean_over`` included, but for one over a
              group of a single rank, which moves nothing.  Their bytes
              are not in ``bytes``.
  peak live   the most bytes held at once by storages the step created,
              each tracked from the op that made it until its last
              tensor is released (the step's arguments not included),
              and the op whose output set it, with its place among the
              step's counted ops.
  saved       the bytes of the step's own storages that autograd saves
              for the backward (``saved_tensors_hooks``), each storage
              once: under activation checkpointing a checkpoint's
              inputs, not the activations it recomputes.

``CostCounter`` is a ``TorchDispatchMode``: ``with CostCounter() as c:
step(...)``, then ``c.totals``.
"""

from __future__ import annotations

import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# metadata ops with no tag that says so: no traffic, no work
_FREE = {
    aten.detach, aten.alias, aten._unsafe_view, aten.lift_fresh, aten.empty, aten.empty_like,
    aten.empty_strided, aten.new_empty, aten.new_empty_strided, aten.set_, aten.resize_,
}
_GATHERS = {aten.index, aten.index_select, aten.gather, aten.embedding, aten.take_along_dim}
_SCATTERS_IN_PLACE = {aten.index_put_, aten._index_put_impl_, aten.index_copy_, aten.scatter_,
                      aten.scatter_add_, aten.index_add_, aten.masked_scatter_}
_WRITES_ONLY = {aten.fill_, aten.zero_}
_SOFTMAX = {aten._softmax, aten._log_softmax, aten._softmax_backward_data, aten._log_softmax_backward_data}
SOFTMAX_FLOPS_PER_ELEMENT = 5

# c10d op -> (kind, index of the operand argument)
_COLLECTIVES = {
    "allreduce_": ("all-reduce", 0), "allreduce_coalesced_": ("all-reduce", 0),
    "allgather_": ("all-gather", 1), "_allgather_base_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "reduce_scatter_": ("reduce-scatter", 1), "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_": ("all-to-all", 1), "alltoall_base_": ("all-to-all", 1),
    "send": ("send/recv", 0), "recv_": ("send/recv", 0), "recv_any_source_": ("send/recv", 0),
    "broadcast_": ("broadcast", 0),
}


def nbytes(t) -> int:
    """Bytes of a tensor's elements (its view, not its storage)."""
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


@dataclass
class CostTotals:
    """A step's counts (``CostCounter``): per device, per step."""

    flops: float = 0.0
    matmul_flops: float = 0.0
    bytes: float = 0.0
    coll_bytes_by_op: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    coll_count_by_op: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    coll_bytes_by_axis: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    coll_bytes_by_axis_op: Dict[str, Dict[str, int]] = field(default_factory=lambda: defaultdict(lambda: defaultdict(int)))
    coll_cross_host_bytes: int = 0
    peak_live_bytes: int = 0
    peak_op: str = ""
    peak_op_index: int = 0  # the peak op's place among ``ops``
    saved_bytes: int = 0
    ops: int = 0

    @property
    def collective_bytes(self) -> int:
        return sum(self.coll_bytes_by_op.values())


class CostCounter(TorchDispatchMode):
    """Counts every aten and c10d op dispatched under it (the module's
    conventions) into ``self.totals``.  ``axes`` maps a process group's
    ``group_name`` to its mesh axis name (``axes_of``); a collective over
    another group is filed under its ranks.  A group whose ranks fall on
    more than one host of ``cards_per_host`` consecutive ranks crosses
    hosts.  The ops themselves run as they would without the counter."""

    def __init__(self, axes: Optional[Dict[str, str]] = None, cards_per_host: int = 8):
        super().__init__()
        self.totals = CostTotals()
        self.axes = dict(axes or {})
        self.cards_per_host = cards_per_host
        self._live: Dict[int, list] = {}  # storage key -> [bytes, live tensors, saved for the backward]
        self._live_bytes = 0

    def __enter__(self):
        self._saving = torch.autograd.graph.saved_tensors_hooks(self._pack, lambda t: t)
        self._saving.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._saving.__exit__(*exc)

    def _pack(self, t):
        entry = self._live.get(t.untyped_storage()._cdata)
        if entry is not None and not entry[2]:  # the step's own storage, first saved
            entry[2] = True
            self.totals.saved_bytes += entry[0]
        return t

    # ------------------------------------------------------------ memory
    def _release(self, key: int) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self._live_bytes -= entry[0]
            del self._live[key]

    def _track(self, outs, arg_keys, func) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in arg_keys and key not in self._live:
                continue  # a view of, or a write into, an argument's storage
            entry = self._live.get(key)
            if entry is None:
                entry = self._live[key] = [st.nbytes(), 0, False]
                self._live_bytes += entry[0]
                if self._live_bytes > self.totals.peak_live_bytes:
                    tot = self.totals
                    tot.peak_live_bytes, tot.peak_op, tot.peak_op_index = self._live_bytes, str(func), tot.ops
            entry[1] += 1
            weakref.finalize(t, self._release, key)

    # ------------------------------------------------------- collectives
    def _collective(self, name: str, args) -> None:
        kind, at = _COLLECTIVES[name]
        size = sum(nbytes(t) for t in _tensors(args[at]))
        pg = next((dist.ProcessGroup.unbox(a) for a in args if isinstance(a, torch.ScriptObject)), None)
        ranks = dist.get_process_group_ranks(pg) if pg is not None else []
        if len(ranks) == 1:
            return  # a group of one rank: nothing moves
        axis = self.axes.get(pg.group_name) if pg is not None else None
        tot = self.totals
        tot.coll_bytes_by_op[kind] += size
        tot.coll_count_by_op[kind] += 1
        axis = axis or f"ranks{ranks[:2]}..{len(ranks)}"
        tot.coll_bytes_by_axis[axis] += size
        tot.coll_bytes_by_axis_op[axis][kind] += size
        if len({r // self.cards_per_host for r in ranks}) > 1:
            tot.coll_cross_host_bytes += size

    # --------------------------------------------------------- fused ops
    def _fused(self, func, args, kwargs):
        """A fused op of the port: it returns nothing and writes the
        arguments its schema marks written."""
        out = func(*args, **kwargs)
        values = [args[i] if i < len(args) else kwargs.get(a.name) for i, a in enumerate(func._schema.arguments)]
        written = [v for v, a in zip(values, func._schema.arguments)
                   if a.alias_info is not None and a.alias_info.is_write]
        ins = _tensors(values)
        tot = self.totals
        tot.ops += 1
        tot.bytes += sum(nbytes(t) for t in ins) + sum(nbytes(t) for t in _tensors(written))
        tot.flops += ins[0].numel() if ins else 0
        return out

    # --------------------------------------------------------------- ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if func.namespace == "c10d":
            if packet.__name__ in _COLLECTIVES:
                self._collective(packet.__name__, args)
            return func(*args, **kwargs)
        if func.namespace == "repro_torch":
            return self._fused(func, args, kwargs)
        if packet not in flop_registry:
            # under inference mode a composite op (matmul, einsum, linear)
            # reaches the mode whole: count the ops it decomposes into, as
            # they reach it under grad or no_grad
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        ins = _tensors(args) + _tensors({k: v for k, v in kwargs.items() if k != "out"})
        arg_keys = {t.untyped_storage()._cdata for t in ins}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        tot = self.totals
        tot.ops += 1
        if func.is_view or packet in _FREE:
            self._track(outs, arg_keys, func)
            return out
        in_b, out_b = sum(nbytes(t) for t in ins), sum(nbytes(t) for t in outs)
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            tot.flops += f
            tot.matmul_flops += f
            tot.bytes += in_b + out_b
        elif packet in _GATHERS:  # the table is the first input, the rest index it
            index = sum(nbytes(t) for t in ins[1:] if not t.is_floating_point())
            tot.bytes += 2 * out_b + index
        elif packet in _SCATTERS_IN_PLACE:  # the destination is the first input
            index = sum(nbytes(t) for t in ins[1:] if not t.is_floating_point())
            tot.bytes += 2 * (in_b - nbytes(ins[0]) - index) + index
        elif packet is aten.copy_:
            tot.bytes += in_b
        elif packet in _WRITES_ONLY:
            tot.bytes += out_b
        else:
            tot.bytes += in_b + out_b
            if packet in _SOFTMAX:
                tot.flops += SOFTMAX_FLOPS_PER_ELEMENT * sum(t.numel() for t in outs)
            elif torch.Tag.reduction in func.tags and ins:
                tot.flops += ins[0].numel()
            elif torch.Tag.pointwise in func.tags:
                tot.flops += sum(t.numel() for t in outs)
        self._track(outs, arg_keys, func)
        return out



def axes_of(mesh) -> Dict[str, str]:
    """{group_name: axis name} of a ``DeviceMesh``'s axes, for
    ``CostCounter(axes=...)``."""
    return {mesh.get_group(name).group_name: name for name in mesh.mesh_dim_names}


def count(fn, *args, axes=None, cards_per_host: int = 8, **kwargs):
    """(fn(*args, **kwargs), its ``CostTotals``)."""
    with CostCounter(axes, cards_per_host) as c:
        out = fn(*args, **kwargs)
    return out, c.totals


__all__ = ["CostCounter", "CostTotals", "axes_of", "count", "nbytes"]
