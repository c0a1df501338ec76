"""Training-side sharding rules: parameter / batch / decode-cache partition
specs for every architecture family, mesh-shape agnostic, turned into
DTensor placements.  (Device-mesh sharding of model state — not the
KV-cache disk tier.)

Strategy (the reference's ``distributed/sharding.py``):
  * TP over ``model``: attention heads, ffn hidden, expert dim, vocab.
  * ZeRO-3/FSDP over ``data`` (and ``pod`` when present for the largest
    archs): the non-TP matrix dim of every weight; optimizer moments
    inherit the parameter spec exactly.
  * Batch over ``(pod, data)``.
  * Decode KV caches: heads over ``model`` when divisible, else the KV
    sequence axis over ``model`` (flash-decoding style partial softmax).

Rules are matched on the parameter's tree path (dict keys joined with '/',
as the reference joins its tree paths), longest match wins; every spec is
filtered against the live mesh's axis names so the same rules serve the
1-pod (data, model) and 2-pod (pod, data, model) meshes.

A mesh here is anything with ``mesh_dim_names`` and ``shape``: a
``torch.distributed.device_mesh.DeviceMesh``, or an ``AbstractMesh``,
which lets the rules be reckoned for a 256-card mesh no process group
holds.  A ``NamedSharding`` gives DTensor ``placements()`` (a dim split
over two mesh axes is ``Shard(d)`` on both, which DTensor splits in mesh
order, the reference's major-to-minor order) and ``shard_slices(shape)``,
each mesh coordinate's index slices, the counterpart of JAX's
``devices_indices_map``.  Trees are nested dicts (``models.common``).
"""

from __future__ import annotations

import itertools
import math
import re
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from ..models.common import MODEL_AXIS, tree_flatten, tree_unflatten

BATCH = ("pod", "data")


class P(tuple):
    """The reference's ``PartitionSpec``: one entry per tensor dim, each
    ``None`` (not split), an axis name, or a tuple of axis names (split
    over their product, the first axis major).  Missing trailing entries
    mean ``None``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no devices or process group."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} in mesh order."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def _parts(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def filter_spec(spec: P, mesh, shape: Optional[Tuple[int, ...]] = None) -> P:
    """Drop axis names the mesh lacks; drop axes that don't divide the dim."""
    names = set(axis_sizes(mesh))
    out = []
    for i, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        parts = entry if isinstance(entry, (tuple, list)) else (entry,)
        kept = [a for a in parts if a in names]
        if shape is not None and kept:
            # keep the largest prefix of axes whose product divides the dim
            prod = 1
            ok = []
            for a in kept:
                prod *= _axis_size(mesh, a)
                if shape[i] % prod == 0:
                    ok.append(a)
                else:
                    prod //= _axis_size(mesh, a)
            kept = ok
        out.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept else None))
    return P(*out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh.  Every axis it names is on the mesh, appears once,
    and a composite entry lists its axes in mesh order (DTensor can split
    one dim over several mesh dims only in that order)."""

    mesh: Any
    spec: P

    def __post_init__(self):
        names = list(axis_sizes(self.mesh))
        seen = []
        for entry in self.spec:
            parts = _parts(entry)
            missing = [a for a in parts if a not in names]
            if missing:
                raise ValueError(f"{self.spec}: axes {missing} are not on the mesh {names}")
            pos = [names.index(a) for a in parts]
            if pos != sorted(pos):
                raise ValueError(f"{self.spec}: the axes {parts} of one dim are not in mesh order {names}; "
                                 "DTensor cannot split a dim so")
            seen += parts
        if len(seen) != len(set(seen)):
            raise ValueError(f"{self.spec}: an axis is used for two dims")

    def placements(self):
        """One DTensor placement per mesh dim: ``Shard(d)`` where the spec
        splits tensor dim d over that axis, else ``Replicate()``."""
        names = list(axis_sizes(self.mesh))
        out = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            for a in _parts(entry):
                out[names.index(a)] = Shard(d)
        return out

    def place(self, t):
        """``t`` (the same whole tensor on every rank) as a DTensor on the
        mesh (a ``DeviceMesh``), moved to its device type first."""
        return distribute_tensor(t.to(self.mesh.device_type), self.mesh, self.placements())

    def shard_slices(self, shape) -> Dict[Tuple[int, ...], Tuple[slice, ...]]:
        """{mesh coordinate: the index slices (one per tensor dim) of the
        shard held there}.  Every split must divide its dim evenly, as
        ``filter_spec`` with a shape leaves it."""
        if len(self.spec) > len(shape):
            raise ValueError(f"{self.spec} has more entries than the shape {tuple(shape)} has dims")
        sizes = axis_sizes(self.mesh)
        entries = list(self.spec) + [None] * (len(shape) - len(self.spec))
        for d, entry in enumerate(entries):
            ways = math.prod(sizes[a] for a in _parts(entry))
            if shape[d] % ways:
                raise ValueError(f"{self.spec}: dim {d} of {tuple(shape)} does not split {ways} ways")
        out = {}
        for coord in itertools.product(*(range(n) for n in sizes.values())):
            at = dict(zip(sizes, coord))
            slices = []
            for d, entry in enumerate(entries):
                idx, ways = 0, 1
                for a in _parts(entry):
                    idx, ways = idx * sizes[a] + at[a], ways * sizes[a]
                step = shape[d] // ways
                slices.append(slice(idx * step, (idx + 1) * step))
            out[coord] = tuple(slices)
        return out


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a dict tree, ``path`` the tuple of keys."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], path + (k,)) for k in sorted(tree)}
    return fn(path, tree)


def place(tree, shardings):
    """Every leaf of ``tree`` as a DTensor under its sharding (a tree of the
    same structure), ``NamedSharding.place``."""
    leaves, treedef = tree_flatten(tree)
    shs = tree_flatten(shardings)[0]
    if len(shs) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves but {len(shs)} shardings")
    return tree_unflatten(treedef, [s.place(t) for t, s in zip(leaves, shs)])


# --------------------------------------------------------------- param rules
# (regex on 'path', ndim-adjusted PartitionSpec builder). Specs are written
# for the UNSTACKED parameter; a leading layer-stack axis is auto-prepended.
# "fsdp" is substituted with the configured ZeRO axis set.

_RULES: Sequence[Tuple[str, Tuple]] = (
    # embeddings: vocab over model, d_model over fsdp
    (r"(^|/)embed$", ("model", "fsdp")),
    (r"(^|/)lm_head$", ("fsdp", "model")),
    # MoE experts (E, D, F) / (E, F, D): expert dim over model (EP)
    (r"moe/w_(gate|up)$", ("model", "fsdp", None)),
    (r"moe/w_down$", ("model", None, "fsdp")),
    (r"moe/router$", (None, None)),
    # MLA: latent ranks are small; shard the head-expanded dim over model
    (r"wq_a$", ("fsdp", None)),
    (r"wq_b$", ("fsdp", "model")),
    (r"wkv_a$", ("fsdp", None)),
    (r"w[kv]_b$", (None, "model")),
    # attention in-projections: heads over model
    (r"(attn|self_attn|cross)/w[qkv]$", ("fsdp", "model")),
    (r"(attn|self_attn|cross)/wo$", ("model", "fsdp")),
    (r"(^|/)wo$", ("model", "fsdp")),
    (r"b[qkv]$", ("model",)),
    # MLP: hidden over model
    (r"mlp/w_(gate|up)$", ("fsdp", "model")),
    (r"mlp/w_down$", ("model", "fsdp")),
    # RWKV6 time-mix: square (D,D) — out dim over model; wo back
    (r"time/w[rkvg]$", ("fsdp", "model")),
    (r"time/lora_a$", (None, "fsdp", None)),
    (r"time/lora_b$", (None, None, "fsdp")),
    # RWKV6 channel-mix
    (r"chan/wk$", ("fsdp", "model")),
    (r"chan/wv$", ("model", "fsdp")),
    (r"chan/wr$", ("fsdp", "model")),
    # Mamba2: inner dim over model
    (r"mamba/w_in$", ("fsdp", "model")),
    (r"mamba/w_out$", ("model", "fsdp")),
    (r"mamba/conv_w$", (None, "model")),
    (r"mamba/conv_b$", ("model",)),
    (r"mamba/norm_w$", ("model",)),
)


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def param_spec_for(path_str: str, ndim: int, stacked: bool, fsdp_axes: Tuple[str, ...]) -> P:
    def expand(entry):
        if entry == "fsdp":
            return fsdp_axes if len(fsdp_axes) != 1 else fsdp_axes[0]
        return entry

    for pat, spec in _RULES:
        if re.search(pat, path_str):
            body = tuple(expand(e) for e in spec)
            if stacked and len(body) == ndim - 1:
                return P(None, *body)
            if len(body) == ndim:
                return P(*body)
            # rank mismatch (e.g. bias rules vs stacked): pad on the left
            if len(body) < ndim:
                return P(*((None,) * (ndim - len(body)) + body))
    return P()  # replicated (norms, scalars, small tables)


# Leaves the rules split over ``model`` whose activations the reference
# constrains nowhere (the embedding's gather, rwkv6's time- and
# channel-mix, the hybrid's Mamba-2 blocks): the models compute with them
# whole on every model rank.
_NO_SITE = r"(^|/)embed$|(^|/)(time|chan|mamba)/"


def model_partial(path_str: str, ndim: int, stacked: bool) -> bool:
    """Whether tensor parallelism leaves the gradient of this leaf a partial
    sum on each ``model`` rank, to be summed over ``model``: the rules
    split it over ``model`` (whether or not ``model`` divides the dim: the
    models take uneven slices) and the models compute with it split.  A
    leaf the rules keep whole has a whole gradient on every rank: it is
    used before the split, or enters it through
    ``models.common.copy_to_model``."""
    if re.search(_NO_SITE, path_str):
        return False
    spec = param_spec_for(path_str, ndim, stacked, ())
    return any(MODEL_AXIS in _parts(e) for e in spec)


def model_partial_leaves(param_specs):
    """``model_partial`` of every leaf of a parameter tree, in
    ``tree_flatten`` order."""
    def leaf(path, x):
        ps = _path_str(path)
        return model_partial(ps, len(x.shape), "blocks" in ps)

    return tree_flatten(_map_with_path(leaf, param_specs))[0]


def param_shardings(mesh, param_specs, fsdp_axes: Tuple[str, ...] = ("data",)):
    """Tensor (or meta tensor) tree -> NamedSharding tree."""

    def leaf(path, x):
        ps = _path_str(path)
        stacked = "blocks" in ps or "enc_blocks" in ps or "dec_blocks" in ps
        spec = param_spec_for(ps, len(x.shape), stacked, fsdp_axes)
        spec = filter_spec(spec, mesh, tuple(x.shape))
        return NamedSharding(mesh, spec)

    return _map_with_path(leaf, param_specs)


def opt_state_shardings(mesh, opt_specs, p_shardings):
    """Optimizer state inherits parameter sharding (ZeRO: moments are
    sharded exactly like their parameter); factored-v stats get the
    parameter spec minus the factored-out dim; step is replicated."""

    def _param_sharding(ppath):
        sub = p_shardings
        for k in ppath:
            sub = sub[k]
        return sub

    m_shardings = _map_with_path(lambda path, x: _param_sharding(path), opt_specs["m"])

    def v_leaf(path, x):
        psh = _param_sharding(path[:-1])
        nd = len(x.shape)
        entries = list(psh.spec) + [None] * (nd + 1 - len(psh.spec))
        kind = path[-1]
        if kind == "v":
            return psh
        if kind == "vr":  # param spec minus last dim
            return NamedSharding(mesh, filter_spec(P(*entries[:nd]), mesh, tuple(x.shape)))
        # vc: param spec minus second-to-last dim
        spec = P(*(entries[: nd - 1] + [entries[nd]]))
        return NamedSharding(mesh, filter_spec(spec, mesh, tuple(x.shape)))

    return {
        "step": NamedSharding(mesh, P()),
        "m": m_shardings,
        "v": _map_with_path(v_leaf, opt_specs["v"]),
    }


# --------------------------------------------------------------- batch/cache
def batch_shardings(mesh, specs):
    """A tensor or a tree of them: dim 0 over the batch axes."""

    def leaf(path, x):
        spec = P(BATCH) if len(x.shape) >= 1 else P()
        return NamedSharding(mesh, filter_spec(spec, mesh, tuple(x.shape)))

    return _map_with_path(leaf, specs)


_ATTN_CACHE = {"k", "v", "attn_k", "attn_v", "self_k", "self_v", "cross_k", "cross_v"}


def cache_shardings(mesh, cache_specs, cfg):
    """KV/state cache sharding for decode, dispatched on the leaf name:

      k/v-style      (L, B, S, KVH, Dh) — batch over (pod,data); heads over
                     model when divisible, else the KV sequence axis
                     (flash-decoding partial softmax)
      c / kr (MLA)   (L, B, S, r)       — batch + sequence over model
      wkv / ssm      (L, B, H, ...)     — batch + heads over model
      *_shift        (L, B, D)          — batch + channels over model
      conv           (L, B, K-1, C)     — batch + channels over model
    """
    model = _axis_size(mesh, "model")

    def leaf(path, x):
        spec, check_shape = cache_spec_for(path[-1], tuple(x.shape), model)
        return NamedSharding(mesh, filter_spec(spec, mesh, check_shape))

    return _map_with_path(leaf, cache_specs)


def cache_spec_for(name: str, shape, model: int):
    """Pure rule: (leaf name, shape, TP degree) -> (PartitionSpec,
    shape-to-check-divisibility-or-None)."""
    nd = len(shape)
    check_shape = shape  # filter axes that don't divide, unless uneven is intended
    entries = [None] * nd
    if nd >= 2:
        entries[1] = BATCH
    if name in _ATTN_CACHE and nd == 5:
        # Never shard the cache SEQ axis: writing one token at a position
        # into a seq-sharded cache rewrites the whole buffer per layer.
        # Prefer KV heads; when they don't divide the TP degree, shard the
        # head-dim instead (the q·k contraction all-reduces one small score
        # chunk, and the update stays local).
        if shape[3] % model == 0 and model > 1:
            entries[3] = "model"
        elif shape[4] % model == 0 and model > 1:
            entries[4] = "model"  # head-dim sharding (contraction axis)
        else:
            entries[2] = "model"  # sequence-parallel decode (last resort)
    elif name in ("c", "kr") and nd == 4:
        # same seq-update hazard as k/v: prefer the latent dim
        if shape[3] % model == 0 and model > 1:
            entries[3] = "model"
        else:
            entries[2] = "model"
    elif name in ("wkv", "ssm") and nd == 5:
        entries[2] = "model"
    elif name in ("time_shift", "chan_shift") and nd == 3:
        entries[2] = "model"
    elif name == "conv" and nd == 4:
        entries[3] = "model"
    return P(*entries), check_shape
