"""``capture``, the port's counterpart of ``jax.jit``: a step captured once
as a CUDA graph and replayed on every call.

The thousands of small launches of a forward leave the host once, at
capture.  On the CPU ``capture`` returns the step itself.  The module sits
below ``serving`` and ``launch``, which both capture their steps.

Launch counts.  The kernels' wrappers count in Python
(``repro_torch.kernels.launch_counts``).  The warm calls before a capture
run the wrappers eagerly, and the capture runs them once more to record
their launches into the graph: both count as they always do.  A replay
runs no wrapper and counts nothing.  ``CapturedStep.replays`` counts the
replays, and what one replay launches is read from a device trace of it
(``chip_smoke.py``, phase ``steps``).
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from . import kernels
from .models.common import tree_flatten, tree_unflatten

WARM_CALLS = 2  # eager calls before a capture: kernel builds, shared-memory attributes, cuBLAS set up


def capture(fn: Callable, *example_args, held=()):
    """The port's ``jax.jit(fn)``: ``fn`` captured once as a CUDA graph on
    the arguments' CUDA device, replayed on every call (a ``CapturedStep``).
    ``example_args`` are ``fn``'s arguments (tensors, or dicts of them);
    the positions in ``held`` are held by reference (parameters, caches):
    every call must pass those same tensors.  The others (tokens, pos,
    frames) are copied into the graph's own buffers on each call.

    Before the capture ``fn`` runs ``WARM_CALLS`` times eagerly on the
    example arguments, on a side stream: a step that updates a held tensor
    in place (a cache) updates it then too, so the caller sets that state
    after capturing.  A failed capture raises; nothing falls back to
    running ``fn`` eagerly (torch leaves a process whose capture failed
    in its capturing state: the capture stream current, allocations
    routed to the graph's pool, so no CUDA work should follow there).
    On the CPU ``fn`` is returned unchanged."""
    leaves = [t for a in example_args for t in tree_flatten(a)[0] if isinstance(t, torch.Tensor)]
    devices = {t.device for t in leaves}
    if len(devices) != 1:
        raise ValueError(f"capture needs the tensors of one device, got {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return fn
    if dev.type != "cuda":
        raise ValueError(f"capture runs on cuda (a CUDA graph) or cpu (the step itself), not {dev}")
    return CapturedStep(fn, example_args, frozenset(held), dev)


class CapturedStep:
    """A step captured as one CUDA graph (built by ``capture``).

    Calling it copies the non-held arguments into the graph's buffers,
    replays the graph on the current stream and returns the graph's own
    output tensors: valid until the next call, which overwrites them.  A
    held argument that is not the captured tensor (data pointer, shape,
    dtype), or another argument of another shape or dtype, raises.

    ``launches`` holds what each kernel's wrapper launched into the graph
    during the capture; ``replays`` counts the calls, each one replay.
    ``capture_s`` is the set-up's wall time (warm calls included),
    ``pool_bytes`` the device memory reserved by the capture (the graph's
    private pool)."""

    def __init__(self, fn: Callable, args, held: frozenset, device: torch.device):
        self.device, self.held = device, held
        self._defs, self._leaves = [], []
        for i, a in enumerate(args):
            leaves, treedef = tree_flatten(a)
            if i not in held:
                leaves = [t.clone() if isinstance(t, torch.Tensor) else t for t in leaves]
            self._defs.append(treedef)
            self._leaves.append(leaves)
        static = [tree_unflatten(d, lv) for d, lv in zip(self._defs, self._leaves)]

        t0 = time.perf_counter()
        # blocks cached for other streams cannot serve the side stream's warm
        # calls: hand them back first (a large step's warm calls need them)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        with torch.cuda.device(device), torch.cuda.stream(side), torch.inference_mode():
            for _ in range(WARM_CALLS):
                fn(*static)
        main.wait_stream(side)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        before = kernels.launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), torch.inference_mode(), torch.cuda.graph(self.graph):
            self.outputs = fn(*static)
        self.launches = {k: n - before[k] for k, n in kernels.launch_counts().items()}
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.replays = 0

    def __call__(self, *args):
        if len(args) != len(self._defs):
            raise TypeError(f"the step was captured with {len(self._defs)} arguments, called with {len(args)}")
        copies = []
        for i, a in enumerate(args):
            leaves, treedef = tree_flatten(a)
            if treedef != self._defs[i]:
                raise ValueError(f"argument {i}: not the structure the step was captured with")
            for new, old in zip(leaves, self._leaves[i]):
                if not isinstance(old, torch.Tensor):
                    if new != old:
                        raise ValueError(f"argument {i}: {new!r} where the step was captured with {old!r}")
                    continue
                if not isinstance(new, torch.Tensor) or new.shape != old.shape or new.dtype != old.dtype:
                    got = f"{tuple(new.shape)} {new.dtype}" if isinstance(new, torch.Tensor) else repr(new)
                    raise ValueError(f"argument {i}: {got} where the step was captured with "
                                     f"{tuple(old.shape)} {old.dtype}; capture a step for this shape")
                if i in self.held:
                    if new.data_ptr() != old.data_ptr() or new.device != old.device:
                        raise ValueError(f"argument {i} is held by reference: pass the tensors the step "
                                         f"was captured with")
                else:
                    copies.append((old, new))
        with torch.cuda.device(self.device), torch.inference_mode():
            for old, new in copies:
                old.copy_(new)
            self.graph.replay()
        self.replays += 1
        return self.outputs
