"""``capture``, the port's counterpart of ``jax.jit``: a step captured once
as a CUDA graph and replayed on every call.

The thousands of small launches of a forward leave the host once, at
capture.  On the CPU ``capture`` returns the step itself.  The module sits
below ``serving`` and ``launch``, which both capture their steps.

Two kinds of step.  A serve step (prefill, decode) is warmed on example
arguments before it is captured, and the caller resets the state it
holds (a cache) afterwards.  A train step advances the state it holds
(parameters and optimizer state, updated in place), so a warm call on
example arguments would take a real optimizer step, and a snapshot to
undo it would copy all of that state: with ``warm_on_calls`` its warm
calls are the step's own first calls instead (see ``capture``).

Launch counts.  The kernels' wrappers count in Python
(``repro_torch.kernels.launch_counts``).  The warm calls before a capture
run the wrappers eagerly, and the capture runs them once more to record
their launches into the graph: both count as they always do.  A replay
runs no wrapper and counts nothing.  ``CapturedStep.replays`` counts the
replays, and what one replay launches is read from a device trace of it
(``chip_smoke.py``, phase ``steps``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import torch

from . import kernels
from .models.common import tree_flatten, tree_unflatten

WARM_CALLS = 2  # eager calls before a capture: kernel builds, shared-memory attributes, cuBLAS set up

_warm_streams = {}  # device -> the side stream every warm call on it runs on


def _warm_stream(device: torch.device) -> "torch.cuda.Stream":
    """The one side stream of ``device`` that every capture's warm calls run
    on.  cuBLAS keeps a workspace for each stream it has run on until the
    process ends (tens of MB each), so a stream made per capture, or per
    warm call, would leave one behind every time."""
    stream = _warm_streams.get(device)
    if stream is None:
        stream = _warm_streams[device] = torch.cuda.Stream(device)
    return stream


def capture(fn: Callable, *example_args, held=(), warm_on_calls: bool = False):
    """The port's ``jax.jit(fn)``: ``fn`` captured once as a CUDA graph on
    the arguments' CUDA device, replayed on every call (a ``CapturedStep``).
    ``example_args`` are ``fn``'s arguments (tensors, or dicts of them);
    the positions in ``held`` are held by reference (parameters, caches,
    optimizer state): every call must pass those same tensors.  The
    others (tokens, pos, frames, a batch) are copied into the graph's own
    buffers on each call.

    Before the capture ``fn`` runs ``WARM_CALLS`` times eagerly, on a side
    stream.  By default that is at once, on the example arguments: a step
    that updates a held tensor in place (a cache) updates it then too, so
    the caller sets that state after capturing.  With ``warm_on_calls``
    nothing runs here: the step's first ``WARM_CALLS`` calls are the warm
    calls, each run eagerly on its own arguments; the next call captures
    ``fn`` on its arguments (a capture executes nothing) and replays the
    graph once; every later call replays.  So each call advances the held
    state exactly once, as a train step must.  A failed capture raises;
    nothing falls back to running ``fn`` eagerly (torch leaves a process
    whose capture failed in its capturing state: the capture stream
    current, allocations routed to the graph's pool, so no CUDA work should
    follow there).
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
    return CapturedStep(fn, example_args, frozenset(held), dev, warm_on_calls)


def capture_at_first_call(fn: Callable, held=()):
    """``fn``, captured (``capture(..., warm_on_calls=True)``) on the
    arguments of its first call that holds CUDA tensors, as ``jax.jit``
    traces at its first call; a call on any other device (the CPU, or
    ``meta`` in the dry run) runs ``fn`` itself.  ``.captured`` is the
    ``CapturedStep`` once there is one."""

    def step(*args):
        if step.captured is None:
            leaves = [t for a in args for t in tree_flatten(a)[0] if isinstance(t, torch.Tensor)]
            if not any(t.device.type == "cuda" for t in leaves):
                return fn(*args)
            step.captured = capture(fn, *args, held=held, warm_on_calls=True)
        return step.captured(*args)

    step.captured = None
    return step


class CapturedStep:
    """A step captured as one CUDA graph (built by ``capture``).

    Calling it copies the non-held arguments into the graph's buffers,
    replays the graph on the current stream and returns the graph's own
    output tensors: valid until the next call, which overwrites them.  A
    held argument that is not the captured tensor (data pointer, shape,
    dtype), or another argument of another shape or dtype, raises.

    ``launches`` holds what each kernel's wrapper launched into the graph
    during the capture; ``replays`` counts the replays.  ``capture_s`` is
    the set-up's wall time (warm calls included, but for ``warm_on_calls``,
    whose warm calls are the caller's own), ``pool_bytes`` the device
    memory reserved by the capture (the graph's private pool).  With
    ``warm_on_calls`` the first ``WARM_CALLS`` calls run ``fn`` eagerly and
    return its own outputs, ``graph`` is None until the call that
    captures, and ``fn`` runs in the caller's grad mode (a train step
    differentiates); else under inference mode."""

    def __init__(self, fn: Callable, args, held: frozenset, device: torch.device, warm_on_calls: bool = False):
        self.fn, self.device, self.held = fn, device, held
        # a train step differentiates: it runs in the caller's grad mode
        self._mode = contextlib.nullcontext if warm_on_calls else torch.inference_mode
        self._defs, self._leaves = [], []
        for i, a in enumerate(args):
            leaves, treedef = tree_flatten(a)
            if i not in held:
                leaves = [t.clone() if isinstance(t, torch.Tensor) else t for t in leaves]
            self._defs.append(treedef)
            self._leaves.append(leaves)
        self.graph, self.outputs, self.launches = None, None, {}
        self.capture_s, self.pool_bytes, self.replays = 0.0, 0, 0
        self.warm_left = WARM_CALLS if warm_on_calls else 0
        if not warm_on_calls:
            t0 = time.perf_counter()
            static = self._static()
            for _ in range(WARM_CALLS):
                self._eager(static)
            self._capture(static)
            self.capture_s = time.perf_counter() - t0

    def _static(self):
        return [tree_unflatten(d, lv) for d, lv in zip(self._defs, self._leaves)]

    def _eager(self, args):
        """``fn(*args)`` on a side stream: warm calls run where the capture
        will, not on the stream the caller's work is queued on."""
        # blocks cached for other streams cannot serve the side stream's warm
        # calls: hand them back first (a large step's warm calls need them)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        main = torch.cuda.current_stream(self.device)
        side = _warm_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.device(self.device), torch.cuda.stream(side), self._mode():
            out = self.fn(*args)
        main.wait_stream(side)
        torch.cuda.synchronize(self.device)
        return out

    def _capture(self, static) -> None:
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        before = kernels.launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), self._mode(), torch.cuda.graph(self.graph):
            self.outputs = self.fn(*static)
        self.launches = {k: n - before[k] for k, n in kernels.launch_counts().items()}
        torch.cuda.synchronize(self.device)
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved

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
        if self.graph is None:
            if self.warm_left:
                self.warm_left -= 1
                return self._eager(args)
            t0 = time.perf_counter()
            for old, new in copies:
                old.copy_(new)
            self._capture(self._static())
            self.capture_s = time.perf_counter() - t0
        with torch.cuda.device(self.device), torch.inference_mode():
            for old, new in copies:
                old.copy_(new)
            self.graph.replay()
        self.replays += 1
        return self.outputs
