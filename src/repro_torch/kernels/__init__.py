"""Hand-written Hopper kernels of the port, one package each:
``<name>/csrc/<name>.cu`` (the kernel, plain C interface), ``<name>/ops.py``
(the wrapper and its launch counter) and ``<name>/ref.py`` (the plain
PyTorch version).  ``include/kernel_common.cuh`` holds what the sources
share; ``_build.py`` compiles them at first use and holds what the
wrappers share (device rule, binding, the launch call)."""

from __future__ import annotations

import re
from typing import Dict, Iterable, Tuple

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

# kernel name -> the __global__ functions of its source of which each
# launch of the wrapper runs exactly one.  A replayed CUDA graph runs no
# wrapper: a device trace counts its launches by these names.
TRACE_SYMBOLS = {
    "flash": ("flash_bf16_kernel", "flash_fwd_kernel"),
    "paged_decode": ("paged_decode_mma_kernel", "paged_decode_split_kernel"),
    "wkv": ("wkv_chunk_kernel",),
    "ssd": ("ssd_local_kernel",),
    "quantize": ("quantize_one_pass_kernel", "quantize_absmax_kernel"),
    "dequantize": ("dequantize_kernel",),
}
_SYMBOL = {kernel: re.compile(r"\b(" + "|".join(symbols) + r")\b") for kernel, symbols in TRACE_SYMBOLS.items()}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTED.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTED.values():
        setattr(mod, attr, 0)


def traced_launch_counts(kernel_runs: Iterable[Tuple[str, int]]) -> Dict[str, int]:
    """Wrapper launches in a device trace.  ``kernel_runs`` are (device
    kernel name, times it ran) pairs, as torch.profiler's
    ``key_averages()`` gives them (``e.key``, ``e.count``); each kernel's
    launches are the runs of its ``TRACE_SYMBOLS``."""
    counts = dict.fromkeys(TRACE_SYMBOLS, 0)
    for name, n in kernel_runs:
        for kernel, pattern in _SYMBOL.items():
            if pattern.search(name):
                counts[kernel] += n
    return counts
