"""Hand-written Hopper kernels of the port, one package each:
``<name>/csrc/<name>.cu`` (the kernel, plain C interface), ``<name>/ops.py``
(the wrapper and its launch counter) and ``<name>/ref.py`` (the plain
PyTorch version).  ``include/kernel_common.cuh`` holds what the sources
share; ``_build.py`` compiles them at first use and holds what the
wrappers share (device rule, binding, the launch call)."""

from __future__ import annotations

from typing import Dict

from .decode_attention import ops as _decode_ops
from .flash_attention import ops as _flash_ops
from .mamba2 import ops as _ssd_ops
from .rwkv6 import ops as _wkv_ops

_COUNTED = {"flash": _flash_ops, "paged_decode": _decode_ops, "wkv": _wkv_ops, "ssd": _ssd_ops}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: mod.launches for name, mod in _COUNTED.items()}


def reset_launch_counts() -> None:
    for mod in _COUNTED.values():
        mod.launches = 0
