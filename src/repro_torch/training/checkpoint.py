"""Checkpoints with atomic commit, in the reference's on-disk format, so
either package reads the other's.

Layout::

    <dir>/step_000123/
        shard_00000.npz      leaf_%05d entries, leaves in tree_flatten order
                             (dict keys sorted at every level, as
                             ``jax.tree.flatten``); a bf16 leaf is stored as
                             leaf_%05d__bf16, its bits viewed as uint16
        MANIFEST.json        {"step", "n_leaves", "extra", "format": 1}: the
                             commit marker

Writes go to ``step_XXX.tmp/``; the manifest is fsynced and the directory
renamed into place, so a crash mid-checkpoint leaves no half-valid step,
and ``latest_step`` and ``prune`` only ever see committed checkpoints (the
train loop's auto-resume contract).

numpy has no bfloat16 of its own and the port does not use ``ml_dtypes``:
bf16 leaves go through their 16-bit integer view both ways.

Under a process group of several ranks, ``save`` is collective: DTensor
leaves are gathered whole (``full_tensor``) on every rank, rank 0 alone
writes and commits, and every rank waits at a barrier until the commit is
done.  Elastic restore: leaves are stored whole, so ``restore`` with
``shardings`` (a tree of ``distributed.sharding.NamedSharding``) places
every leaf for the current mesh — a checkpoint taken on one mesh shape
restores onto any other.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..models.common import tree_flatten, tree_unflatten


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save(ckpt_dir: str, step: int, tree, extra: Optional[Dict] = None) -> str:
    """Atomically persist ``tree`` (params/opt_state/metadata tree); every
    rank of an open process group calls it."""
    leaves, _ = tree_flatten(tree)
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    if _rank() != 0:
        for leaf in leaves:  # the gathers are collective
            if isinstance(leaf, DTensor):
                leaf.full_tensor()
        dist.barrier()
        return final
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    arrs = {}
    for i, leaf in enumerate(leaves):
        a = _to_numpy(leaf)
        if leaf.dtype == torch.bfloat16:  # npz can't store bf16 natively
            arrs[f"leaf_{i:05d}__bf16"] = a
        else:
            arrs[f"leaf_{i:05d}"] = a
    np.savez(os.path.join(tmp, "shard_00000.npz"), **arrs)
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "extra": extra or {},
        "format": 1,
    }
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    if dist.is_initialized():
        dist.barrier()
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest *committed* step (tmp dirs and manifest-less dirs ignored)."""
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for name in os.listdir(ckpt_dir):
        if not name.startswith("step_") or name.endswith(".tmp"):
            continue
        if not os.path.exists(os.path.join(ckpt_dir, name, "MANIFEST.json")):
            continue
        s = int(name.split("_")[1])
        best = s if best is None else max(best, s)
    return best


def _from_numpy(a: np.ndarray, bf16: bool, device) -> torch.Tensor:
    if not a.flags.c_contiguous:
        a = np.array(a, order="C")
    if bf16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def restore(ckpt_dir: str, step: int, like, shardings=None, device="cuda"):
    """Restore a tree saved by ``save`` (by either package).  ``like``
    supplies the tree structure; dtypes are the stored ones.  Every leaf
    is placed on ``device``, or, with ``shardings`` (a tree like ``like``'s
    of ``NamedSharding`` on a ``DeviceMesh``), as a DTensor under its
    sharding on the mesh's device type.  Returns (tree, manifest)."""
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    leaves_like, treedef = tree_flatten(like)
    if manifest["n_leaves"] != len(leaves_like):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, expected {len(leaves_like)}"
        )
    shs = None if shardings is None else tree_flatten(shardings)[0]
    if shs is not None and len(shs) != len(leaves_like):
        raise ValueError(f"{len(shs)} shardings for {len(leaves_like)} leaves")
    out = []
    with np.load(os.path.join(path, "shard_00000.npz")) as data:
        for i in range(len(leaves_like)):
            bf16 = f"leaf_{i:05d}__bf16" in data
            a = data[f"leaf_{i:05d}__bf16" if bf16 else f"leaf_{i:05d}"]
            out.append(_from_numpy(a, bf16, device) if shs is None else shs[i].place(_from_numpy(a, bf16, "cpu")))
    return tree_unflatten(treedef, out), manifest


def prune(ckpt_dir: str, keep: int = 3) -> None:
    steps = sorted(
        int(n.split("_")[1])
        for n in os.listdir(ckpt_dir)
        if n.startswith("step_") and not n.endswith(".tmp")
        and os.path.exists(os.path.join(ckpt_dir, n, "MANIFEST.json"))
    )
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:09d}"))
