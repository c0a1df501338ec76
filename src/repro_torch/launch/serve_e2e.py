"""End-to-end serving on the device: a real model with batched requests
through the full stack —

    staged workload -> ServingEngine (two-stage pipeline on the runtime's
                       I/O executor; write-behind commits; off-path
                       maintenance)
                    -> CacheHierarchy (radix + tiers; plan/fetch/fulfill)
                    -> ShardedKVBlockStore (4 LSM shards on real disk), or
                       any other StorageBackend the caller passes (a
                       ClusterKVBlockStore over node processes)
                    -> real prefill and greedy decode on the device, through
                       the flash and paged decode kernels, each step
                       captured as a CUDA graph (repro_torch.graphs.capture)
                       before the engine starts

The workload is the reference's ``examples/serve_e2e.py`` unchanged.  KV
blocks written to and promoted from the disk tier are the model's actual
cache tensors; TTFT is measured (real compute + real I/O).

    main(arch="qwen3-14b")                      # full width, on the card
    main(arch="qwen3-14b", smoke=True, device="cpu")
"""

from __future__ import annotations

import dataclasses
import shutil
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..cache.hierarchy import CacheHierarchy
from ..configs import get_config
from ..configs.base import ShapeConfig
from ..core.sharded_store import ShardedKVBlockStore
from ..graphs import capture
from ..models import api
from ..models.common import resolve_device
from ..runtime import RuntimeServices
from ..serving import ComputeModel, ServingEngine
from ..serving.real_prefill import make_real_prefill
from ..workload import StagedWorkload
from .steps import build_decode_step

BLOCK = 16
PROMPT = 128
DECODE_TOKENS = 8
N_SHARDS = 4


def prefill_inputs(cfg, toks, frames=None) -> Dict:
    """The prefill batch dict: ``tokens``, and for encdec the encoder's
    input ``frames`` (B, enc_frames, d_model), which it needs."""
    if cfg.family != "encdec":
        return {"tokens": toks}
    if frames is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: its prefill needs frames (B, enc_frames, d_model)")
    return {"tokens": toks, "frames": frames}


@dataclasses.dataclass
class GreedySteps:
    """The prefill and decode steps of ``greedy_decode`` for one prompt
    length and token count, with the cache and the position they hold."""
    prefill: Callable  # (params, batch, cache) -> last-token logits (1, V)
    decode: Callable  # (params, tokens (1, 1), cache, pos) -> (logits (1, V), cache)
    cache: Dict
    pos: torch.Tensor  # 0-d int32 on the device
    prompt_len: int
    n_tokens: int


def make_greedy_steps(cfg, params, prompt_len: int, n_tokens: int, device, plain_kernels: bool = False,
                      frames=None, graphs: bool = True) -> GreedySteps:
    """``greedy_decode``'s steps: a held cache of prompt_len + n_tokens
    slots, the prefill at 0 into it and one decode step at a device
    ``pos``.  On a CUDA device both are captured as CUDA graphs
    (``repro_torch.graphs.capture``), as the reference example jits
    ``api.prefill_fn`` and ``api.decode_fn``; ``graphs=False`` keeps the
    steps eager through the kernels, ``plain_kernels`` eager through their
    plain versions.  An encdec model takes example ``frames`` (1,
    enc_frames, d_model), whose shape and dtype a captured prefill
    keeps."""
    dev = torch.device(device)
    shape = ShapeConfig("greedy_decode", prompt_len + n_tokens, 1, "decode")
    pfn = api.prefill_fn(cfg, plain_kernels)
    decode = build_decode_step(cfg, shape, plain_kernels)

    def prefill(params, batch, cache):
        return pfn(params, batch, cache, 0)[0][:, -1, :]

    with torch.inference_mode():
        cache = api.init_cache(cfg, 1, shape.seq_len, dev)
        pos = torch.tensor(prompt_len, dtype=torch.int32, device=dev)
        if graphs and not plain_kernels:
            toks = torch.zeros((1, prompt_len), dtype=torch.int64, device=dev)
            batch = prefill_inputs(cfg, toks, None if frames is None else torch.zeros_like(frames))
            prefill = capture(prefill, params, batch, cache, held=(0, 2))
            decode = capture(decode, params, toks[:, :1], cache, pos, held=(0, 2))
    return GreedySteps(prefill, decode, cache, pos, prompt_len, n_tokens)


def greedy_decode(cfg, params, prompt: List[int], n_tokens: int, device,
                  plain_kernels: bool = False, inputs: Optional[List[int]] = None, frames=None,
                  graphs: bool = True, steps: Optional[GreedySteps] = None):
    """Prefill ``prompt`` and decode ``n_tokens`` greedily.  With ``inputs``,
    step i is fed ``inputs[i]`` instead of the previous argmax (teacher
    forcing).  An encdec model takes ``frames`` (1, enc_frames, d_model),
    the encoder's input.  Returns (argmax tokens, the tokens fed, per-step
    logits (n_tokens, V) as float32 on the device).

    The steps are ``steps`` (from ``make_greedy_steps``, built once and
    reused: a captured step is set up once) or made here with
    ``plain_kernels`` and ``graphs``.  The held cache is zeroed and
    ``pos`` set to the prompt's length; the loop advances ``pos`` in place
    and feeds each argmax back on the device, so the host waits once, for
    the final tokens."""
    if steps is None:
        steps = make_greedy_steps(cfg, params, len(prompt), n_tokens, device, plain_kernels, frames, graphs)
    if (steps.prompt_len, steps.n_tokens) != (len(prompt), n_tokens):
        raise ValueError(f"steps for a {steps.prompt_len}-token prompt and {steps.n_tokens} tokens, "
                         f"asked for {len(prompt)} and {n_tokens}")
    cache, pos = steps.cache, steps.pos
    with torch.inference_mode():
        for t in cache.values():  # a fresh state: the last run (or a capture's warm calls) left its own
            t.zero_()
        pos.fill_(len(prompt))
        toks = torch.tensor(prompt, dtype=torch.int64, device=device)[None, :]
        last = steps.prefill(params, prefill_inputs(cfg, toks, frames), cache).argmax(-1, keepdim=True)
        if inputs is not None:
            fed = torch.tensor(inputs, dtype=torch.int64, device=device)[:, None, None]
        out, fed_tokens, logit_rows = [], [], []
        for i in range(n_tokens):
            if inputs is not None:
                last = fed[i]
            fed_tokens.append(last)
            logits, _ = steps.decode(params, last, cache, pos)
            logit_rows.append(logits[0].to(torch.float32, copy=True))  # a graph's output is overwritten next call
            last = logits.argmax(-1, keepdim=True)
            out.append(last)
            pos += 1
        tokens = torch.cat(out).flatten().tolist()
        fed_list = torch.cat(fed_tokens).flatten().tolist()
    return tokens, fed_list, torch.stack(logit_rows)


def make_engine(cfg, hook, store, runtime: RuntimeServices) -> ServingEngine:
    """The engine ``main`` serves with: empty device and host tiers over
    ``store``, prefills through ``hook``."""
    h = CacheHierarchy(BLOCK, device_budget_blocks=64, host_budget_blocks=128, store=store)
    kv_per_tok_elems = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.d_head
    return ServingEngine(h, ComputeModel(cfg), kv_bytes_per_token=kv_per_tok_elems * 2,
                         max_batch_tokens=2048, real_prefill=hook, runtime=runtime)


def main(arch: str = "qwen3-14b", smoke: bool = False, device="cuda", seed: int = 0,
         corpus_size: int = 8, requests_per_stage: int = 6, params=None,
         verbose: bool = True, cfg=None, store=None, tap=None) -> Dict:
    """Serve the staged workload and decode a few tokens.  ``params`` reuses
    weights already on the device (else they are drawn from ``seed``);
    ``cfg`` serves that config in place of ``arch``'s (a cut of one: fewer
    layers at the same widths).  ``store`` is the disk tier, a
    ``StorageBackend`` the caller owns and closes (else a 4-shard
    ``ShardedKVBlockStore`` in a temporary directory, closed here);
    ``tap(hook)`` returns the callable the engine is given in place of the
    hook (a caller records what the hook hands over).
    Every step is captured before the engine starts: the hook's prefill
    and the decode's steps.  Returns per-stage hit and TTFT, every
    request's reuse, the decoded tokens with their inputs and logits, the
    number of prefills the run made, the corpus the warm-up served, and
    the steps (``hook``: the engine's hook, ``greedy_steps``: the
    decode's)."""
    dev = resolve_device(device)
    say = print if verbose else (lambda *a, **k: None)
    if cfg is None:
        cfg = get_config(arch, smoke=smoke)
    if params is None:
        params = api.init_params(cfg, seed, dev)
    hook = make_real_prefill(cfg, params, BLOCK, dev, lengths=(PROMPT,))
    greedy_steps = make_greedy_steps(cfg, params, PROMPT, DECODE_TOKENS, dev)

    runtime = RuntimeServices(io_threads=4)
    root = None
    if store is None:
        root = tempfile.mkdtemp(prefix="serve_e2e_")
        store = ShardedKVBlockStore(root, n_shards=N_SHARDS, block_size=BLOCK,
                                    io_executor=runtime.executor)
    eng = make_engine(cfg, hook if tap is None else tap(hook), store, runtime)
    h = eng.h
    try:
        wl = StagedWorkload(prompt_len=PROMPT, requests_per_stage=requests_per_stage,
                            stages=(0.0, 0.5, 0.75), block_size=BLOCK,
                            corpus_size=corpus_size, seed=0)
        say(f"serving {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}) on {dev} — "
            f"real prefill, real disk tier")
        # warmup: populate the corpus write-through (paper §4.1)
        for p in wl.warmup_prompts(len(wl.corpus) * PROMPT):
            eng.submit(type("R", (), {"tokens": p[:PROMPT], "rid": -1, "stage": -1})())
        eng.run()
        stages, requests = [], []
        for si in range(len(wl.stages)):
            for r in wl.stage_requests(si):
                eng.submit(r)
            recs = eng.run()
            hit = float(np.mean([r.reused_tokens / r.prompt_len for r in recs]))
            ttft = float(np.mean([r.ttft_s for r in recs]))
            stages.append({"stage": si, "expect_hit": wl.stages[si], "hit": hit, "ttft_s": ttft,
                           "io_s": float(np.mean([r.io_s for r in recs])),
                           "compute_s": float(np.mean([r.compute_s for r in recs]))})
            requests += [{"rid": r.rid, "stage": r.stage, "reused_tokens": r.reused_tokens}
                         for r in recs]
            say(f"stage {si} (expect hit {wl.stages[si]:.2f}): hit {hit:.2f}, "
                f"TTFT {ttft*1e3:.1f}ms (io {np.mean([r.io_s for r in recs])*1e3:.1f}ms, "
                f"wait {np.mean([r.io_wait_s for r in recs])*1e3:.1f}ms)")
        eng.drain()  # settle write-behind + maintenance before the report

        # a short decode to show the serve path end to end
        t0 = time.perf_counter()
        out, fed, logits = greedy_decode(cfg, params, wl.corpus[0][:PROMPT], DECODE_TOKENS, dev,
                                         steps=greedy_steps)
        decode_s = time.perf_counter() - t0
        say(f"decoded {DECODE_TOKENS} tokens: {out}")
        layout = (f"shards={store.n_shards} files/shard={store.shard_file_counts()}"
                  if isinstance(store, ShardedKVBlockStore) else f"{store.name} files={store.file_count}")
        say(f"store: {layout} "
            f"bytes={store.disk_bytes} compression={store.stats.compression_ratio:.2f}x "
            f"hit-tiers d/h/d={h.stats.tokens_hit_device}/"
            f"{h.stats.tokens_hit_host}/{h.stats.tokens_hit_disk}")
        rep = eng.runtime_report()
        say(f"runtime: prefetched={rep['prefetched_requests']} "
            f"(ready on arrival {rep['prefetch_ready']}) overlap={rep['overlap_io_s']*1e3:.1f}ms "
            f"writeback_blocks={rep['writeback_blocks']} "
            f"maintenance_runs={rep['maintenance_runs']}")
        return {
            "arch": cfg.name, "n_layers": cfg.n_layers, "device": str(dev),
            "stages": stages, "requests": requests, "decoded": out, "decode_inputs": fed, "decode_logits": logits,
            "decode_s": decode_s, "prompt": wl.corpus[0][:PROMPT], "corpus": [p[:PROMPT] for p in wl.corpus],
            # the engine's prefills plus the one in front of the decode
            "prefills": hook.calls + 1, "decode_steps": DECODE_TOKENS,
            "store_bytes": store.disk_bytes, "hook": hook, "greedy_steps": greedy_steps,
        }
    finally:
        eng.close()
        if root is not None:
            store.close()
            shutil.rmtree(root, ignore_errors=True)
