"""Closed-loop serving through the program's engine.

The engine is built as ``repro_torch.launch.serve_e2e.make_engine`` builds
it (a ``CacheHierarchy`` of block 16 over the store, ``max_batch_tokens``
2048, the real-prefill hook), with the traffic file's tier budgets, over
``make_real_prefill`` (the prompt length of the traffic, captured once) and
a 4-shard ``ShardedKVBlockStore`` (int8 + zlib codec) under TMPDIR, with
``RuntimeServices(io_threads=4)``: write-behind commits and prefetch on
the I/O executor.

Set-up: weights, the hook's capture, the engine, the warm-up (every
document once) and the drain of its writes.  The window: ``clients``
clients each submit a request and, when its record comes back from
``ServingEngine.step``, the next; a request's TTFT runs from its submit to
the return of the step that served it.  Requests still in flight when the
window closes are served but not counted.

A routed model's expert choices (``kvbench/arch/``'s contract): where the
program's hook has an attribute ``route``, ``{layer: (S, k) int}`` on the
device covering every position its last call computed, the tap keeps a
device clone of it beside that call's blocks.  The reservoir keeps the
clones of the sampled requests and drops the rest; the sample's routes go
to the host only once the window has closed.  A hook without ``route``
costs nothing.
"""

from __future__ import annotations

import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np

from .. import check, procio, trace, weights

BLOCK = 16
N_SHARDS = 4
SAMPLE = 4  # requests held against the reference, drawn from the seed


def _delta(after, before, fields) -> Dict[str, float]:
    return {f: getattr(after, f) - getattr(before, f) for f in fields}


CACHE_FIELDS = ("requests", "tokens_requested", "tokens_hit_device", "tokens_hit_host", "tokens_hit_disk",
                "tokens_missed", "promote_s")
COMMIT_FIELDS = ("completed", "completed_bytes", "stall_s", "drain_s")


def run(ctx) -> Dict:
    from repro_torch.core.sharded_store import ShardedKVBlockStore
    from repro_torch.launch.serve_e2e import make_engine
    from repro_torch.runtime import RuntimeServices
    from repro_torch.serving.real_prefill import make_real_prefill

    tr, model, dev = ctx.traffic, ctx.model, ctx.device
    if tr["loop"] != "closed":
        raise ValueError(f"the engine_loop runner runs a closed loop, the traffic asks for {tr['loop']!r}")
    gen = ctx.generator(tr["generator"], model["vocab_size"], ctx.seed)
    S = gen.prompt_len
    phases = ctx.phases

    with phases.timed("weights"):
        params = weights.make(ctx.arch, model, ctx.seed, dev)
    with phases.timed("capture"):
        hook = make_real_prefill(ctx.port_cfg, params, BLOCK, dev, lengths=(S,))
    # the routes are read from the program's own hook: a fault a test plants
    # around it alters the blocks
    program_hook, hook = hook, ctx.fault("hook", hook)
    runtime = RuntimeServices(io_threads=tr["io_threads"])
    root = tempfile.mkdtemp(prefix="kvbench_store_")
    store = ShardedKVBlockStore(root, n_shards=N_SHARDS, block_size=BLOCK, io_executor=runtime.executor)
    store.get_batch = ctx.fault("get_batch", store.get_batch)

    # what the timed path hands over, in call order: the cache's blocks of
    # each request's reused prefix, and the hook's fresh blocks with the
    # program's routes (None from a hook without them)
    taken: List = []
    made: List = []

    def tapped_hook(tokens, reused):
        blocks, secs = hook(tokens, reused)
        route = getattr(program_hook, "route", None)
        made.append((blocks, None if route is None else {i: ids.clone() for i, ids in route.items()}))
        return blocks, secs

    eng = make_engine(ctx.port_cfg, tapped_hook, store, runtime)
    h = eng.h
    h.device_budget, h.host_budget = tr["tiers"]["device_blocks"], tr["tiers"]["host_blocks"]
    fulfill = h.fulfill

    def tapped_fulfill(plan, fetched=None):
        acq = fulfill(plan, fetched)
        taken.append([n.data for n in acq.nodes])
        return acq

    h.fulfill = tapped_fulfill
    fetch_s: List = []  # (start, seconds) of each fetch
    spans = trace.Spans() if ctx.trace else None
    if ctx.trace:
        fetch = h.fetch

        def timed_fetch(plan):
            t = time.perf_counter()
            try:
                return fetch(plan)
            finally:
                fetch_s.append((t, time.perf_counter() - t))

        h.fetch = spans.wrap(timed_fetch, "fetch")
        h.plan = spans.wrap(h.plan, "plan")
        h.fulfill = spans.wrap(h.fulfill, "fulfill")
        h.commit = spans.wrap(h.commit, "commit")
        eng.real_prefill = spans.wrap(eng.real_prefill, "prefill")
    try:
        with phases.timed("warmup"):
            for r in gen.warmup():
                eng.submit(r)
            eng.run()
        with phases.timed("drain"):
            eng.drain()
        taken.clear()
        made.clear()

        window = _window(ctx, eng, gen, taken, made, fetch_s, spans)
        window["memory_peak_bytes"] = ctx.memory_peak()
        eng.close()
    finally:
        store.close()
        shutil.rmtree(root, ignore_errors=True)
    del eng, hook, program_hook, h
    ctx.free()

    done, samples = window["requests"], window.pop("samples")
    for s in samples:
        if "route" in s:
            s["route"] = {i: ids.cpu() for i, ids in s["route"].items()}
    t_check = time.perf_counter()
    nums = check.kv_numbers(ctx.arch, params, model, samples, BLOCK, dev, control=ctx.control)
    check_s = time.perf_counter() - t_check
    # every request of the window, not only the sample: its reuse as built,
    # and each block it took back present
    nums["program"]["reuse_mismatches"] = float(sum(r["reused"] != r["expected_reuse"] for r in done))
    nums["program"]["blocks_missing"] = float(sum(r["missing"] for r in done))
    if "control" in nums:
        nums["control"].update(reuse_mismatches=0.0, blocks_missing=0.0)
    window.update(numbers=nums["program"], control=nums.get("control"), prefill_flops=ctx.arch.prefill_flops(model, S),
                  flash_call=ctx.arch.flash_call(model, S), sampled=len(samples), check_s=check_s)
    return window


def _window(ctx, eng, gen, taken, made, fetch_s, spans) -> Dict:
    h, commits, model = eng.h, eng.runtime.commits, ctx.model
    reqs = gen.requests()
    inflight: Dict[int, Dict] = {}
    done: List[Dict] = []
    # a reservoir of SAMPLE requests with their blocks, uniform over the
    # window's requests, drawn from the seed (Algorithm R)
    rng, samples = np.random.default_rng(ctx.seed), []
    late = 0
    prof = trace.DeviceWindow(ctx.device, spans) if ctx.trace else None
    p0, p1 = ctx.traffic["profile_requests"]

    def submit():
        r = next(reqs)
        inflight[r.rid] = {"req": r, "t": time.perf_counter()}
        eng.submit(r)

    def snapshot():
        return h.stats.__class__(**vars(h.stats)), commits.stats.__class__(**vars(commits.stats)), procio.wchar()

    for _ in range(int(ctx.traffic["clients"])):
        submit()
    # the loop's first requests fill the pipeline (the first fetch has no
    # prefill to hide under): they are set-up, and the window opens on the
    # loop already running
    warm = int(ctx.traffic["warm_requests"])
    t0 = t_end = before = after = None
    while inflight:
        recs = eng.step()
        now = time.perf_counter()
        if len(taken) != len(recs) or len(made) != len(recs):
            raise RuntimeError(f"a step served {len(recs)} requests, the taps saw {len(taken)} and {len(made)}")
        for rec, prom, (fresh, route) in zip(recs, taken, made):
            f = inflight.pop(rec.rid)
            if t0 is None:
                warm -= 1
            elif now <= t_end:
                r = f["req"]
                done.append({"ttft_s": now - f["t"], "prompt_len": rec.prompt_len, "reused": rec.reused_tokens,
                             "expected_reuse": r.expected_reuse, "io_wait_s": rec.io_wait_s,
                             "compute_s": rec.compute_s, "missing": sum(b is None for b in prom)})
                s = {"tokens": r.tokens, "reused": rec.reused_tokens, "fresh": fresh, "promoted": prom}
                if route is not None:
                    s["route"] = route
                i = len(done) - 1
                if i < SAMPLE:
                    samples.append(s)
                else:
                    j = int(rng.integers(0, i + 1))
                    if j < SAMPLE:
                        samples[j] = s
            else:
                late += 1
                continue
            submit()
        taken.clear()
        made.clear()
        if t0 is None:
            if warm <= 0:
                before = snapshot()
                fetch_s.clear()
                t0 = ctx.window_start()
                t_end = t0 + ctx.seconds
            continue
        if prof is not None:
            if len(done) >= p0 and prof.fresh and now <= t_end:
                prof.start()
            elif prof.open and (len(done) >= p1 or now > t_end):
                prof.stop()
        if after is None and now > t_end:
            after = snapshot()
    if prof is not None and prof.open:
        prof.stop()
    cache1, commit1, w1 = after if after is not None else snapshot()
    cache0, commit0, w0 = before
    return {
        "window_s": ctx.seconds, "requests": done, "samples": samples, "late": late,
        "cache": _delta(cache1, cache0, CACHE_FIELDS), "commit": _delta(commit1, commit0, COMMIT_FIELDS),
        "wchar": None if w0 is None or w1 is None else w1 - w0,
        "block_bytes": ctx.arch.block_bytes(model, BLOCK),
        "fetch_s": [d for t, d in fetch_s if t0 <= t <= t_end],
        "profile": None if prof is None else prof.summary(),
    }
