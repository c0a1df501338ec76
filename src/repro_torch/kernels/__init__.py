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
from .kv_codec import ops as _codec_ops
from .mamba2 import ops as _ssd_ops
from .rwkv6 import ops as _wkv_ops

# kernel name -> (wrapper module, the module's counter of that kernel's launches)
_COUNTED = {
    "flash": (_flash_ops, "launches"),
    "paged_decode": (_decode_ops, "launches"),
    "wkv": (_wkv_ops, "launches"),
    "ssd": (_ssd_ops, "launches"),
    "quantize": (_codec_ops, "quantize_launches"),
    "dequantize": (_codec_ops, "dequantize_launches"),
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTED.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTED.values():
        setattr(mod, attr, 0)
