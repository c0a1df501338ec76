"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Runs the full serving stack — staged workload -> radix/LSM cache hierarchy
-> continuous-batching engine — with the disk tier on real files.  Compute
is modeled and I/O measured, as in the reference launcher
(``repro/launch/serve.py``, DESIGN.md §7); real compute on the card is
``launch/serve_e2e.main(arch=...)``.

The engine builder is the port's copy of what the reference launcher
takes from ``benchmarks/common.py``, under the same names: ``BenchScale``,
``_budgets``, ``make_backend``, ``make_engine``, ``StageResult`` and
``run_staged``.  It builds on the port's byte-identical copies of
``core/``, ``cache/``, ``serving/engine.py`` and ``workload/``.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
from dataclasses import dataclass
from typing import List

import numpy as np

from ..cache.hierarchy import CacheHierarchy
from ..configs import get_config
from ..core.baselines import FilePerObjectStore
from ..core.codec import CODEC_INT8, CODEC_RAW, BatchCodec
from ..core.sharded_store import ShardedKVBlockStore
from ..core.store import KVBlockStore
from ..serving import ComputeModel, ServingEngine
from ..workload import PAPER_STAGES, StagedWorkload


@dataclass
class BenchScale:
    """Container-scale defaults; --paper-scale multiplies everything up."""

    prompt_len: int = 1024
    requests_per_stage: int = 30
    stages: tuple = PAPER_STAGES
    corpus_size: int = 96
    kv_bytes_per_token: int = 1024
    block_size: int = 16
    warmup_tokens: int = 0  # 0 -> one pass over the corpus
    disk_budget_frac: float = 0.5  # of the raw corpus footprint
    mem_budget_frac: float = 0.06
    device_frac: float = 0.33  # of the memory budget


def _budgets(s: BenchScale):
    corpus_bytes = s.corpus_size * s.prompt_len * s.kv_bytes_per_token
    disk = int(corpus_bytes * s.disk_budget_frac)
    mem_blocks = max(
        8, int(corpus_bytes * s.mem_budget_frac) // (s.block_size * s.kv_bytes_per_token)
    )
    dev_blocks = max(4, int(mem_blocks * s.device_frac))
    host_blocks = mem_blocks - dev_blocks
    return disk, dev_blocks, host_blocks


def make_backend(root: str, kind: str, s: BenchScale, adaptive: bool = True):
    disk, _, _ = _budgets(s)
    if kind == "lsm":
        # controller window ~ one workload stage of ops so phase shifts are
        # visible to the drift detector (paper §3.3 sliding window)
        window = max(256, s.requests_per_stage * (s.prompt_len // s.block_size) // 2)
        store = KVBlockStore(
            os.path.join(root, "lsm"),
            block_size=s.block_size,
            codec=BatchCodec(CODEC_INT8, use_zlib=True),
            budget_bytes=disk,
            adaptive=adaptive,
            controller_window=window,
        )
        store.controller.min_ops_between_tunings = window // 4
        return store
    if kind == "lsm-sharded":
        window = max(256, s.requests_per_stage * (s.prompt_len // s.block_size) // 2)
        store = ShardedKVBlockStore(
            os.path.join(root, "lsm_sharded"),
            n_shards=4,
            block_size=s.block_size,
            codec=BatchCodec(CODEC_INT8, use_zlib=True),
            budget_bytes=disk,
            adaptive=adaptive,
            controller_window=window,
        )
        for shard in store.shards:
            # per-shard window was scaled down by 1/n_shards in the store
            shard.controller.min_ops_between_tunings = max(64, shard.controller.window // 4)
        return store
    if kind == "file":
        # file-per-object stores raw tensors (per-object compression defeats
        # batching — paper §3.4); same *physical* disk budget incl. fs slack
        return FilePerObjectStore(
            os.path.join(root, "file"),
            block_size=s.block_size,
            codec=BatchCodec(CODEC_RAW, use_zlib=False),
            budget_bytes=disk,
        )
    if kind == "memory":
        return None
    raise ValueError(kind)


def make_engine(root: str, kind: str, s: BenchScale, arch: str = "glm4-9b", adaptive=True):
    cfg = get_config(arch)
    store = make_backend(root, kind, s, adaptive)
    disk, dev_blocks, host_blocks = _budgets(s)
    h = CacheHierarchy(s.block_size, dev_blocks, host_blocks, store=store)
    return ServingEngine(
        h,
        ComputeModel(cfg),
        kv_bytes_per_token=s.kv_bytes_per_token,
        max_batch_tokens=8 * s.prompt_len,
    )


@dataclass
class StageResult:
    stage: int
    expected_hit: float
    hit_rate: float
    mean_ttft_s: float
    mean_io_s: float
    mean_compute_s: float


def run_staged(engine: ServingEngine, s: BenchScale, seed: int = 0) -> List[StageResult]:
    wl = StagedWorkload(
        prompt_len=s.prompt_len,
        requests_per_stage=s.requests_per_stage,
        stages=s.stages,
        block_size=s.block_size,
        corpus_size=s.corpus_size,
        seed=seed,
    )
    # ---- warmup: write-through population over the corpus (paper §4.1)
    warm = s.warmup_tokens or s.corpus_size * s.prompt_len
    for p in wl.warmup_prompts(warm):
        engine.submit(type("R", (), {"tokens": p, "rid": -1, "stage": -1})())
    engine.run()
    engine.stats.ttfts.clear()
    engine.stats.hits.clear()

    # a stage is submitted at once, so a stage's TTFT is each request's
    # service time (``RequestRecord.service_s`` = ttft_s - queue_s), as the
    # reference's: the wall-clock wait behind the stage's earlier requests
    # stays out of a sum with modeled compute
    out: List[StageResult] = []
    for si in range(len(s.stages)):
        for r in wl.stage_requests(si):
            engine.submit(r)
        recs = engine.run()
        out.append(
            StageResult(
                stage=si,
                expected_hit=s.stages[si],
                hit_rate=float(np.mean([r.reused_tokens / r.prompt_len for r in recs])),
                mean_ttft_s=float(np.mean([r.service_s for r in recs])),
                mean_io_s=float(np.mean([r.io_s for r in recs])),
                mean_compute_s=float(np.mean([r.compute_s for r in recs])),
            )
        )
    return out


def main(argv=None) -> List[StageResult]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--backend", default="lsm", choices=["lsm", "file", "memory"])
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--stages", default="0.2,0.5,0.7")
    ap.add_argument("--root", default=None)
    args = ap.parse_args(argv)

    stages = tuple(float(x) for x in args.stages.split(","))
    s = BenchScale(
        prompt_len=args.prompt_len,
        requests_per_stage=args.requests,
        stages=stages,
        corpus_size=max(16, args.requests),
    )
    root = args.root or tempfile.mkdtemp(prefix="serve_")
    eng = make_engine(root, args.backend, s, arch=args.arch)
    try:
        results = run_staged(eng, s)
        print(f"[launch.serve] arch={args.arch} backend={args.backend} prompt={args.prompt_len}")
        print(f"{'stage':>5s} {'exp_hit':>8s} {'hit':>6s} {'TTFT(s)':>9s} {'IO(ms)':>8s}")
        for st in results:
            print(f"{st.stage:5d} {st.expected_hit:8.2f} {st.hit_rate:6.3f} "
                  f"{st.mean_ttft_s:9.4f} {st.mean_io_s*1e3:8.2f}")
        if eng.h.store is not None:
            st = eng.h.store
            print(f"[store] files={st.file_count} disk={st.disk_bytes/1e6:.1f}MB "
                  + (f"compression={st.stats.compression_ratio:.2f}x" if hasattr(st.stats, "compression_ratio") else ""))
    finally:
        eng.close()
        if eng.h.store is not None:
            eng.h.store.close()
        if args.root is None:
            shutil.rmtree(root, ignore_errors=True)
    return results


if __name__ == "__main__":
    main()
