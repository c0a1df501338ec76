"""End-to-end serving on the device: a real model with batched requests
through the full stack —

    staged workload -> ServingEngine (two-stage pipeline on the runtime's
                       I/O executor; write-behind commits; off-path
                       maintenance)
                    -> CacheHierarchy (radix + tiers; plan/fetch/fulfill)
                    -> ShardedKVBlockStore (4 LSM shards on real disk)
                    -> real prefill and greedy decode on the device, through
                       the flash and paged decode kernels

The workload is the reference's ``examples/serve_e2e.py`` unchanged.  KV
blocks written to and promoted from the disk tier are the model's actual
cache tensors; TTFT is measured (real compute + real I/O).

    main(arch="qwen3-14b")                      # full width, on the card
    main(arch="qwen3-14b", smoke=True, device="cpu")
"""

from __future__ import annotations

import shutil
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..cache.hierarchy import CacheHierarchy
from ..configs import get_config
from ..core.sharded_store import ShardedKVBlockStore
from ..models import api
from ..runtime import RuntimeServices
from ..serving import ComputeModel, ServingEngine
from ..serving.real_prefill import make_real_prefill
from ..workload import StagedWorkload

BLOCK = 16
PROMPT = 128
DECODE_TOKENS = 8
N_SHARDS = 4


def resolve_device(device) -> torch.device:
    """The device a run asked for; a CUDA device that is not there raises
    rather than falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' asked for, but no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return dev


def greedy_decode(cfg, params, prompt: List[int], n_tokens: int, device,
                  plain_attention: bool = False, inputs: Optional[List[int]] = None):
    """Prefill ``prompt`` and decode ``n_tokens`` greedily.  With ``inputs``,
    step i is fed ``inputs[i]`` instead of the previous argmax (teacher
    forcing).  Returns (argmax tokens, the tokens fed, per-step logits
    (n_tokens, V) as float32 on the device)."""
    prefill = api.prefill_fn(cfg, plain_attention)
    decode = api.decode_fn(cfg, plain_attention)
    with torch.inference_mode():
        toks = torch.tensor(prompt, dtype=torch.int64, device=device)[None, :]
        cache = api.init_cache(cfg, 1, len(prompt) + n_tokens, device)
        logits, cache = prefill(params, {"tokens": toks}, cache, 0)
        last = logits[:, -1:].argmax(-1)
        if inputs is not None:
            fed = torch.tensor(inputs, dtype=torch.int64, device=device)[:, None, None]
        out, fed_tokens, steps = [], [], []
        for i in range(n_tokens):
            if inputs is not None:
                last = fed[i]
            fed_tokens.append(last)
            logits, cache = decode(params, last, cache, len(prompt) + i)
            steps.append(logits[0, -1].float())
            last = logits[:, -1:].argmax(-1)
            out.append(last)
        tokens = torch.cat(out).flatten().tolist()
        fed_list = torch.cat(fed_tokens).flatten().tolist()
    return tokens, fed_list, torch.stack(steps)


def main(arch: str = "qwen3-14b", smoke: bool = False, device="cuda", seed: int = 0,
         corpus_size: int = 8, requests_per_stage: int = 6, params=None,
         verbose: bool = True) -> Dict:
    """Serve the staged workload and decode a few tokens.  ``params`` reuses
    weights already on the device (else they are drawn from ``seed``).
    Returns per-stage hit and TTFT, every request's reuse, the decoded
    tokens with their inputs and logits, and the number of prefills the
    run made."""
    dev = resolve_device(device)
    say = print if verbose else (lambda *a, **k: None)
    cfg = get_config(arch, smoke=smoke)
    if params is None:
        params = api.init_params(cfg, seed, dev)
    kv_per_tok_elems = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.d_head
    hook = make_real_prefill(cfg, params, BLOCK, dev)

    root = tempfile.mkdtemp(prefix="serve_e2e_")
    runtime = RuntimeServices(io_threads=4)
    store = ShardedKVBlockStore(root, n_shards=N_SHARDS, block_size=BLOCK,
                                io_executor=runtime.executor)
    h = CacheHierarchy(BLOCK, device_budget_blocks=64, host_budget_blocks=128, store=store)
    eng = ServingEngine(h, ComputeModel(cfg), kv_bytes_per_token=kv_per_tok_elems * 2,
                        max_batch_tokens=2048, real_prefill=hook, runtime=runtime)
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
        out, fed, logits = greedy_decode(cfg, params, wl.corpus[0][:PROMPT], DECODE_TOKENS, dev)
        decode_s = time.perf_counter() - t0
        say(f"decoded {DECODE_TOKENS} tokens: {out}")
        say(f"store: shards={store.n_shards} files/shard={store.shard_file_counts()} "
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
            "decode_s": decode_s, "prompt": wl.corpus[0][:PROMPT],
            # the engine's prefills plus the one in front of the decode
            "prefills": hook.calls + 1, "decode_steps": DECODE_TOKENS,
            "store_bytes": store.disk_bytes,
        }
    finally:
        eng.close()
        store.close()
        shutil.rmtree(root, ignore_errors=True)
