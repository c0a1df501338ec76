"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each kernel keeps its source in ``kernels/<name>/csrc/<name>.cu`` with a
plain C interface (no PyTorch headers), so one ``nvcc`` call per source
takes seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -I kernels/include -o build/kernels/lib<name>_<hash>.so <name>.cu

``kernels/include/`` holds what every source shares.  The library lands in
``build/kernels/`` at the root of the checkout, named by a hash of its
source and the shared headers, so an edit to either is rebuilt and an
unchanged kernel is loaded as it is (``native/build.py``, which the host
C decoder shares).  ``build_all()`` starts every ``nvcc`` at once and
waits for all of them.  A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import shutil
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

from ..native.build import Command, build_libraries, library_file, load_library

KERNELS_DIR = Path(__file__).resolve().parent
INCLUDE_DIR = KERNELS_DIR / "include"
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]


def kernel_names() -> List[str]:
    return sorted(p.parent.parent.name for p in KERNELS_DIR.glob("*/csrc/*.cu"))


def source_path(name: str) -> Path:
    return KERNELS_DIR / name / "csrc" / f"{name}.cu"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = source_path(name).read_bytes() + b"".join(h.read_bytes() for h in sorted(INCLUDE_DIR.glob("*.cuh")))
    return library_file(BUILD_DIR, name, src + " ".join(NVCC_FLAGS).encode())


def nvcc_command(name: str, out: Path) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o", str(out), str(source_path(name))]


def _job(name: str) -> Tuple[Path, Command]:
    return library_path(name), functools.partial(nvcc_command, name)


def build_all(names: List[str] | None = None) -> Dict[str, float]:
    """Compile every kernel that is not built yet, all ``nvcc`` processes
    started together; load each library.  Returns seconds per kernel
    (0.0 for one already loaded or built)."""
    names = kernel_names() if names is None else names
    return build_libraries({n: _job(n) for n in names})


def load(name: str) -> ctypes.CDLL:
    return load_library(name, *_job(name))


def run_on(what: str, device, plain: Callable, kernel: Callable, *, inputs: Sequence):
    """Every wrapper's device rule: a CPU tensor takes the plain version, a
    CUDA tensor launches the kernel (which raises where it cannot launch),
    any other device raises.  There is no fallback from kernel to plain.

    No kernel has a backward, and a kernel fills a fresh tensor outside
    autograd, so on CUDA an op whose tensor ``inputs`` require grad while
    grad mode is on raises rather than return outputs cut off from the
    graph.  The plain versions stay differentiable."""
    if device.type == "cpu":
        return plain()
    if device.type != "cuda":
        raise ValueError(f"{what} runs on cuda (kernel) or cpu (plain), not {device}")
    import torch

    if torch.is_grad_enabled() and any(getattr(t, "requires_grad", False) for t in inputs):
        raise RuntimeError(f"{what}: the CUDA kernel has no backward, and an input requires grad; run it "
                           f"under torch.no_grad() or torch.inference_mode(), or differentiate through the "
                           f"plain path (plain_kernels=True)")
    return kernel()


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


_bound: Dict[str, ctypes.CDLL] = {}


def bind(name: str, signatures: Dict[str, Tuple[object, list]]) -> ctypes.CDLL:
    """Kernel ``name``'s library, built if need be, with its C entry points
    typed once: ``signatures`` maps a symbol to (restype, argtypes)."""
    lib = _bound.get(name)
    if lib is None:
        lib = load(name)
        for symbol, (restype, argtypes) in signatures.items():
            fn = getattr(lib, symbol)
            fn.restype, fn.argtypes = restype, argtypes
        _bound[name] = lib
    return lib


def call(lib: ctypes.CDLL, prefix: str, entry: str, device, *args) -> None:
    """Call ``entry`` with ``args`` and ``device``'s current CUDA stream as
    its last argument; raise on a nonzero status (see ``check``)."""
    import torch

    with torch.cuda.device(device):
        status = getattr(lib, entry)(*args, torch.cuda.current_stream(device).cuda_stream)
    check(lib, prefix, status)


def check(lib: ctypes.CDLL, prefix: str, status: int) -> None:
    """Raise when a kernel's C entry point returned a nonzero cudaError_t;
    ``<prefix>_error_string`` in the library names the error."""
    if status != 0:
        fn = getattr(lib, f"{prefix}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{prefix} launch failed: CUDA error {status} ({fn(status).decode()})")
