"""Greedy decode, back to back, through the program's captured steps.

Set-up: weights, then ``repro_torch.launch.serve_e2e.make_greedy_steps``
for the traffic's prompt and output lengths (the prefill and one decode
step, each captured as a CUDA graph).  The window: one client runs
``greedy_decode`` on each request in turn until the window has passed; the
requests that ended in the window count.  The steps' prefill is wrapped so
that the device is synchronised and the host clock read at its end: a
request's decode time runs from there to the return of ``greedy_decode``,
which waits for the last token.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from .. import check, roofline, trace, weights


def run(ctx) -> Dict:
    from repro_torch.launch.serve_e2e import greedy_decode, make_greedy_steps

    tr, model, dev = ctx.traffic, ctx.model, ctx.device
    gen = ctx.generator(tr["generator"], model["vocab_size"], ctx.seed)
    P, n = gen.prompt_len, gen.output_tokens
    phases = ctx.phases
    with phases.timed("weights"):
        params = weights.make(ctx.arch, model, ctx.seed, dev)
    with phases.timed("capture"):
        steps = make_greedy_steps(ctx.port_cfg, params, P, n, dev)

    marks: List[float] = []
    prefill, decode = steps.prefill, steps.decode

    def timed_prefill(*args):
        out = prefill(*args)
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize(dev)
        marks.append(time.perf_counter())
        return out

    spans = trace.Spans() if ctx.trace else None
    prof = trace.DeviceWindow(dev, spans) if ctx.trace else None
    s0, s1 = tr["profile_steps"]
    calls = [0]

    def traced_decode(*args):
        if prof is not None and prof.fresh and calls[0] == s0:
            prof.start()
        out = decode(*args)
        calls[0] += 1
        if prof is not None and prof.open and calls[0] == s1:
            prof.stop()
        return out

    stepped = ctx.fault("decode", traced_decode)
    if spans is not None:
        timed_prefill, stepped = spans.wrap(timed_prefill, "prefill"), spans.wrap(stepped, "decode")
    steps = dataclasses.replace(steps, prefill=timed_prefill, decode=stepped)
    reqs = gen.requests()
    done: List[Dict] = []
    t0 = ctx.window_start()
    t_end = t0 + ctx.seconds
    while True:
        r = next(reqs)
        marks.clear()
        c0 = calls[0]
        out, fed, logits = greedy_decode(ctx.port_cfg, params, r.tokens, n, dev, steps=steps)
        now = time.perf_counter()
        if now > t_end:
            break
        done.append({"prompt": r.tokens, "fed": fed, "served": [fed[0]] + out, "logits": logits,
                     "decode_s": now - marks[0], "profiled": prof is not None and c0 <= s0 < calls[0]})
    if prof is not None and prof.open:
        prof.stop()
    peak = ctx.memory_peak()
    del steps, prefill, decode
    ctx.free()

    rng = np.random.default_rng(ctx.seed)
    pick = sorted(rng.choice(len(done), size=min(tr["sample"], len(done)), replace=False).tolist()) if done else []
    t_check = time.perf_counter()
    nums = check.decode_numbers(ctx.arch, params, model, [done[i] for i in pick], dev, control=ctx.control)
    check_s = time.perf_counter() - t_check
    kv0 = P + 1  # the first decode step attends over the prompt and its own token
    step_bounds = [roofline.bound_s(*ctx.arch.decode_step(model, kv0 + i))[0] for i in range(n)]
    paged = None
    profile = None if prof is None else prof.summary()
    if profile is not None:
        paged = sum(roofline.bound_s(*ctx.arch.paged_decode_call(model, kv0 + i % n))[0]
                    for i in range(s0, s1)) * model["n_layers"]
    return {
        "window_s": ctx.seconds, "memory_peak_bytes": peak, "late": 1,
        "requests": [{"decode_s": d["decode_s"], "steps": n, "profiled": d["profiled"]} for d in done],
        "decode_bound_s": sum(step_bounds), "paged_decode_bound_s": paged,
        "profile": profile,
        "numbers": nums["program"], "control": nums.get("control"), "sampled": len(pick), "check_s": check_s,
    }
