"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each kernel keeps its source in ``kernels/<name>/csrc/<name>.cu`` with a
plain C interface (no PyTorch headers), so one ``nvcc`` call per source
takes seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/lib<name>_<hash>.so <name>.cu

The library lands in ``build/kernels/`` at the root of the checkout, named
by a hash of its source, so an edited source is rebuilt and an unchanged
one is loaded as it is.  ``build_all()`` starts every ``nvcc`` at once and
waits for all of them.  A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Tuple

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


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
    src = source_path(name).read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def nvcc_command(name: str, out: Path) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(source_path(name))]


def _start(name: str) -> Tuple[Path, subprocess.Popen | None, Path]:
    out = library_path(name)
    if out.exists():
        return out, None, out
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = nvcc_command(name, tmp)  # raises first when there is no toolkit
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, proc, tmp


def build_all(names: List[str] | None = None) -> Dict[str, float]:
    """Compile every kernel that is not built yet, all ``nvcc`` processes
    started together; load each library.  Returns seconds per kernel
    (0.0 for one already loaded or built)."""
    names = kernel_names() if names is None else names
    with _lock:
        t0 = time.perf_counter()
        started = {n: _start(n) for n in names if n not in _libs}
        seconds: Dict[str, float] = {n: 0.0 for n in names}
        errors = []
        for n, (out, proc, tmp) in started.items():
            if proc is not None:
                log, _ = proc.communicate()
                seconds[n] = time.perf_counter() - t0
                if proc.returncode != 0:
                    head = "\n".join(log.splitlines()[:40])
                    errors.append(f"nvcc failed for {n} (exit {proc.returncode}):\n{head}")
                    continue
                os.replace(tmp, out)
            _libs[n] = ctypes.CDLL(str(out))
        if errors:
            raise RuntimeError("\n".join(errors))
        return seconds


def load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = _libs[name]
    return lib


def check(lib: ctypes.CDLL, prefix: str, status: int) -> None:
    """Raise when a kernel's C entry point returned a nonzero cudaError_t;
    ``<prefix>_error_string`` in the library names the error."""
    if status != 0:
        fn = getattr(lib, f"{prefix}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{prefix} launch failed: CUDA error {status} ({fn(status).decode()})")
