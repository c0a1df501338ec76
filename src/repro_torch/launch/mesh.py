"""Mesh construction (the reference's ``launch/mesh.py``) and the hardware
constants of the port's card.

``make_production_mesh`` and ``make_smoke_mesh`` are functions (never
module-level state), so importing this module touches no device or
process group.  The 1-pod mesh is (data=16, model=16) = 256 cards; the
2-pod mesh prepends a pure-DP ``pod`` axis = 512 cards.  Each is a
``DeviceMesh`` over the default process group, whose world size must equal
the mesh's size; to reckon the rules for a mesh no process group holds,
use ``distributed.sharding.AbstractMesh`` (``production_mesh_shape``), and
to trace a step as one rank of it, ``fake_mesh`` (a fake process group in
this process, for the dry run).

Constants of one NVIDIA H100 SXM, from NVIDIA's H100 Tensor Core GPU
datasheet (SXM part, dense rates without sparsity, at the full 700 W power
limit):

  PEAK_FLOPS_BF16  989 TFLOP/s, bf16 on the tensor cores
  PEAK_FLOPS_TF32  494.7 TFLOP/s, TF32 on the tensor cores (f32 work's bound)
  HBM_BW           3.35 TB/s of HBM3
  NVLINK_BW        900 GB/s of NVLink to the other cards of the host, all
                   to all (450 GB/s each way)

and of the 8-card HGX H100 host, from NVIDIA's DGX H100 datasheet:

  CARDS_PER_HOST   8 cards joined by NVLink; ranks are numbered host by host
  IB_BW            50 GB/s a card between hosts: 8 ConnectX-7 at 400 Gb/s
                   per 8-card host, one a card
"""

from __future__ import annotations

import contextlib
import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..distributed.sharding import AbstractMesh
from ..models.common import resolve_device

PEAK_FLOPS_BF16 = 989e12  # per card, dense
PEAK_FLOPS_TF32 = 494.7e12  # per card, dense
HBM_BW = 3.35e12  # bytes/s per card
NVLINK_BW = 900e9  # bytes/s per card, aggregate over its links
CARDS_PER_HOST = 8
IB_BW = 50e9  # bytes/s per card, InfiniBand between hosts


def init_process_group(device="cuda") -> bool:
    """Open the default process group unless one is open: from the
    environment ``torchrun`` sets (``WORLD_SIZE``, ``RANK``,
    ``MASTER_ADDR``...), else a group of world size 1 over an in-process
    store.  NCCL for ``cuda``, gloo for ``cpu``; under ``torchrun`` each
    rank takes the card of its ``LOCAL_RANK``.  Returns whether it opened
    one (and so the caller should destroy it)."""
    if dist.is_initialized():
        return False
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return True


def _mesh(shape, names, device):
    if not dist.is_initialized():
        raise RuntimeError(f"a {dict(zip(names, shape))} mesh needs a process group: "
                           "launch.mesh.init_process_group opens one")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"the mesh {dict(zip(names, shape))} has {math.prod(shape)} devices, "
                         f"but the process group has world size {world}")
    return init_device_mesh(resolve_device(device).type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_smoke_mesh(data: int = 2, model: int = 2, pod: int = 0, device="cuda"):
    """A small mesh over the process group's ranks (tests, the launcher)."""
    if pod:
        return _mesh((pod, data, model), ("pod", "data", "model"), device)
    return _mesh((data, model), ("data", "model"), device)


def production_mesh_shape(*, multi_pod: bool = False) -> AbstractMesh:
    """The production mesh's axes and sizes, with no process group."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


@contextlib.contextmanager
def fake_mesh(mesh):
    """``with fake_mesh(mesh) as dm:`` this process as rank 0 of a fake
    process group (``torch.testing``'s "fake" backend: collectives return
    at once and move nothing) of the size of ``mesh`` (an ``AbstractMesh``
    or anything with ``shape`` and ``mesh_dim_names``), and ``dm`` a
    ``DeviceMesh`` of its axes over it, in mesh order.  A step traced under
    ``models.common.tensor_parallel(dm)`` on meta tensors is rank 0's, with
    every collective it would make.  The group is the process's default
    one: none may be open, and it is destroyed on exit."""
    try:  # a private module of torch's own tests: it registers the "fake" backend
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise ImportError(f"fake_mesh needs torch's fake process group, torch.testing._internal.distributed."
                          f"fake_pg, a private module with no stability promise, known to work with torch 2.11 and "
                          f"2.13; this torch is {torch.__version__}") from e

    if dist.is_initialized():
        raise RuntimeError("fake_mesh opens this process's default process group, and one is open")
    shape, names = tuple(mesh.shape), tuple(mesh.mesh_dim_names)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=names)
    finally:
        dist.destroy_process_group()
