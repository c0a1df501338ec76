"""The real-prefill hook of the serving engine: run the model over a prompt
on the device and hand back the KV blocks the store persists.

The hook has the engine's signature ``(tokens, reused) -> (blocks,
seconds)``.  It recomputes the whole prompt and drops the blocks the cache
already supplied, exactly as the reference hook in ``examples/serve_e2e.py``
does, and synchronises the device before it stops the clock (without that
the time would measure only the launches).

Each block keeps the reference's stored layout, so one store can hold
blocks from either package: ``(block, 2·L·KVH·Dh)`` float16, k then v,
each the (L, block, KVH, Dh) slab reshaped as numpy's
``reshape(block, -1, order="F")`` does.  That layout spreads the layers
across a block's rows; it is the stored format and is kept as it is.
"""

from __future__ import annotations

import time
from typing import Callable, List, Tuple

import numpy as np
import torch

from ..models import api


def fortran_blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """(L, n*block, KVH, Dh) -> (n, block, L*KVH*Dh): block i equals
    ``x[:, i*block:(i+1)*block].reshape(block, -1, order="F")`` in numpy.
    For one slab y of shape (L, block, KVH, Dh) the F-order reshape is
    ``y.permute(3, 2, 1, 0).reshape(-1, block).T``; this does all blocks at
    once."""
    L, T, KVH, Dh = x.shape
    n = T // block
    y = x.reshape(L, n, block, KVH, Dh).permute(1, 4, 3, 2, 0)  # (n, Dh, KVH, block, L)
    return y.reshape(n, -1, block).transpose(1, 2)


def make_real_prefill(cfg, params, block: int, device="cuda") -> Callable:
    """Return the engine's ``real_prefill`` hook for ``cfg`` and ``params``
    on ``device``.  ``hook.calls`` counts the prefills it ran."""
    prefill = api.prefill_fn(cfg)

    def real_prefill(tokens, reused) -> Tuple[List[np.ndarray], float]:
        t0 = time.perf_counter()
        with torch.inference_mode():
            toks = torch.tensor(tokens, dtype=torch.int64, device=device)[None, :]
            cache = api.init_cache(cfg, 1, len(tokens), device)
            prefill(params, {"tokens": toks}, cache, 0)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            real_prefill.calls += 1
            nb = len(tokens) // block
            start = reused // block
            if start >= nb:
                return [], dt
            sl = slice(start * block, nb * block)
            # bf16 -> f16 on the device rounds once, as the reference's
            # bf16 -> f32 -> f16 does, and halves the bytes copied out
            k = fortran_blocks(cache["k"][:, 0, sl].to(torch.float16), block)
            v = fortran_blocks(cache["v"][:, 0, sl].to(torch.float16), block)
            out = torch.cat([k, v], dim=2).cpu().numpy()
        return list(out), dt

    real_prefill.calls = 0
    return real_prefill
