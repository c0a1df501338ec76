"""Shared helpers for the parity tests of the PyTorch port (``repro_torch``)
against the JAX reference (``repro``): parameter conversion, array
conversion, the reference's real-prefill hook and a reference engine run.

Inputs are made with numpy from a seed and handed to both packages; JAX
runs on the CPU and Pallas kernels in interpret mode, as the reference's
own tests run them.
"""

from __future__ import annotations

import tempfile
import time
from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.models.convert import from_numpy_tree

# Tolerances, each with its reason.
F32_TOL = 2e-5    # f32 end to end: the reference kernel tests' own tolerance
BF16_TOL = 2e-2   # bf16 outputs: both sides round an f32 result to 8 mantissa bits
# smoke models in bf16 (2 layers): matmuls round to bf16 at different
# places in XLA and in torch, so logits may differ by a few bf16 ulps
MODEL_TOL = 5e-2


def jax_to_numpy_tree(tree) -> Dict:
    """JAX parameter tree -> numpy tree; bf16 leaves as their int16 bit view
    (the form ``repro_torch.models.convert`` takes)."""
    def leaf(a):
        a = np.asarray(a)
        return a.view(np.int16) if a.dtype == jnp.bfloat16 else a

    return jax.tree.map(leaf, tree)


def jax_params_to_torch(params, device="cpu") -> Dict:
    return from_numpy_tree(jax_to_numpy_tree(params), device)


def np32(x) -> np.ndarray:
    """torch or JAX array -> float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, np.float32)


def torch_from(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


def jax_from(a: np.ndarray, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


def jax_real_prefill(cfg, params, block: int):
    """The reference hook of ``examples/serve_e2e.py`` (lines 49-67)."""
    from repro.models import api

    prefill = jax.jit(api.prefill_fn(cfg))

    def real_prefill(tokens, reused):
        t0 = time.perf_counter()
        toks = jnp.asarray(tokens, jnp.int32)[None, :]
        cache = api.init_cache(cfg, 1, len(tokens))
        logits, cache = prefill(params, {"tokens": toks}, cache, 0)
        jax.block_until_ready(logits)
        dt = time.perf_counter() - t0
        k, v = np.asarray(cache["k"], np.float32), np.asarray(cache["v"], np.float32)
        nb = len(tokens) // block
        start = reused // block
        blocks = []
        for i in range(start, nb):
            sl = slice(i * block, (i + 1) * block)
            blk = np.concatenate([k[:, 0, sl].reshape(block, -1, order="F"),
                                  v[:, 0, sl].reshape(block, -1, order="F")], axis=1)
            blocks.append(blk.astype(np.float16))
        return blocks, dt

    return real_prefill


def jax_engine_reuse(cfg, params, corpus_size: int, requests_per_stage: int,
                     block: int = 16, prompt: int = 128) -> List[Dict]:
    """Every request's reuse when the reference engine, fed by the reference
    hook, serves the workload of ``examples/serve_e2e.py`` (reduced)."""
    from repro.cache.hierarchy import CacheHierarchy
    from repro.core.sharded_store import ShardedKVBlockStore
    from repro.runtime import RuntimeServices
    from repro.serving import ComputeModel, ServingEngine
    from repro.workload import StagedWorkload

    kv_per_tok = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.d_head
    runtime = RuntimeServices(io_threads=4)
    with tempfile.TemporaryDirectory(prefix="serve_ref_") as root:
        store = ShardedKVBlockStore(root, n_shards=4, block_size=block, io_executor=runtime.executor)
        h = CacheHierarchy(block, device_budget_blocks=64, host_budget_blocks=128, store=store)
        eng = ServingEngine(h, ComputeModel(cfg), kv_bytes_per_token=kv_per_tok * 2,
                            max_batch_tokens=2048, real_prefill=jax_real_prefill(cfg, params, block),
                            runtime=runtime)
        wl = StagedWorkload(prompt_len=prompt, requests_per_stage=requests_per_stage,
                            stages=(0.0, 0.5, 0.75), block_size=block, corpus_size=corpus_size, seed=0)
        for p in wl.warmup_prompts(len(wl.corpus) * prompt):
            eng.submit(type("R", (), {"tokens": p[:prompt], "rid": -1, "stage": -1})())
        eng.run()
        out = []
        for si in range(len(wl.stages)):
            for r in wl.stage_requests(si):
                eng.submit(r)
            out += [{"rid": r.rid, "stage": r.stage, "reused_tokens": r.reused_tokens} for r in eng.run()]
        eng.drain()
        eng.close()
        store.close()
    return out
