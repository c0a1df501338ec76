"""How the port builds and loads its hand-written libraries, CUDA kernels
(``kernels/_build.py``, nvcc) and host C (``block_decode``, cc) alike.

A library is named by a hash of what it is built from (its sources and
flags): ``<build dir>/lib<stem>_<hash>.so``, so an edit renames, and so
rebuilds, it and an unchanged one is loaded as it is.  A missing file is
compiled under a temporary name and renamed into place, so concurrent
processes build safely; each file is loaded with ``ctypes.CDLL`` once a
process.  Imports neither torch nor the kernels, so a storage process
builds its decoder without them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple

# the command that compiles a library into the path it is given
Command = Callable[[Path], List[str]]

_lock = threading.Lock()
_libs: Dict[Path, ctypes.CDLL] = {}


def library_file(build_dir: Path, stem: str, key: bytes) -> Path:
    return build_dir / f"lib{stem}_{hashlib.sha1(key).hexdigest()[:12]}.so"


def _start(out: Path, command: Command) -> Tuple[subprocess.Popen | None, Path]:
    if out.exists():
        return None, out
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = command(tmp)  # raises first when there is no compiler
    out.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp


def build_libraries(jobs: Dict[str, Tuple[Path, Command]]) -> Dict[str, float]:
    """Build and load every library of ``jobs`` (name -> its file and the
    command that compiles it) not loaded yet, every compiler started at once.
    Returns seconds per name (0.0 for one already loaded or built).  A failed
    build raises, naming each that failed."""
    with _lock:
        t0 = time.perf_counter()
        started = {n: (out, *_start(out, command)) for n, (out, command) in jobs.items() if out not in _libs}
        seconds: Dict[str, float] = {n: 0.0 for n in jobs}
        errors = []
        for n, (out, proc, tmp) in started.items():
            if proc is not None:
                log, _ = proc.communicate()
                seconds[n] = time.perf_counter() - t0
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    head = "\n".join(log.splitlines()[:40])
                    errors.append(f"{Path(proc.args[0]).name} failed for {n} (exit {proc.returncode}):\n{head}")
                    continue
                os.replace(tmp, out)
            _libs[out] = ctypes.CDLL(str(out))
        if errors:
            raise RuntimeError("\n".join(errors))
        return seconds


def load_library(name: str, out: Path, command: Command) -> ctypes.CDLL:
    lib = _libs.get(out)
    if lib is None:
        build_libraries({name: (out, command)})
        lib = _libs[out]
    return lib
