#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, in order, one line each:
  1. device        card name and power limit (nvidia-smi), torch and CUDA versions
  2. build         compile every kernel from the sources in the checkout (nvcc)
  3. flash         flash-attention kernel vs its plain version on the card, bf16,
                   at the serve path's shape, a ragged-offset case over a strided
                   cache slice, and a 4096-token prefill; device times (CUDA-graph
                   replay) of kernel, plain version and SDPA (yardstick only: the
                   port never calls it)
  4. paged_decode  paged decode kernel vs its plain version at the serve path's
                   shape (kv_len 129..136), a batch of 32 with mixed kv_len up to
                   4096 over shuffled tables and one kv_len = 0 row; the
                   paged-pool staging check; times as above
  5. serve         full-width qwen3-14b through launch.serve_e2e.main: staged
                   workload -> ServingEngine -> CacheHierarchy -> 4-shard
                   ShardedKVBlockStore on disk, real prefill and greedy decode;
                   launch counters reset just before and read just after
  6. decode-check  the decoded tokens again through the plain attention versions
                   on the card (teacher-forced): token agreement and logit error;
                   warm prefill and decode times of both paths; a torch.profiler
                   pass over one prefill (device busy time, idle share)
  7. kernels       one JSON line describing both kernels

Every phase runs on every call.  Any failed phase raises and the exit code
is nonzero.  The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the rest
of the repository beside this file, the script exits nonzero and prints no
result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12    # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
ARCH = "qwen3-14b"
SEED = 0
# bf16: kernel and plain version both compute in f32 and round the result to
# bf16 (8 significant bits), so they differ by at most one bf16 step, 2^-7
# of the value; the limit allows two.  The atol covers outputs near zero,
# where only the f32 summation order differs.  It stays far below a typical
# output (about 0.03 at the long shapes), so a dropped key tile or page fails.
BF16_RTOL = 2.0**-6
BF16_ATOL = 1e-4
F32_TOL = 1e-4     # atol = rtol: f32 sums taken in another order than the plain version's einsum
LOGIT_REL_TOL = 0.05  # decode-check: max |dlogit| <= 5% of max |logit|
MIN_TOKEN_AGREEMENT = 7 / 8  # a near-tie may flip one argmax


def line(phase: str, **kv) -> None:
    body = " ".join(f"{k}={v}" for k, v in kv.items())
    print(f"[{phase}] {body}", flush=True)


def time_ms(fn, iters: int, reps: int = 5) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph, the
    graph replayed ``reps`` times between CUDA events; the median per call.
    Replayed, the kernels run back to back, so the host's launch overhead
    (larger than a microsecond kernel) is not in the number.  Inputs stay in
    the 50 MB L2 between calls at the serve shapes, as the serve path
    leaves the K/V it has just written."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def assert_close(name: str, out, ref, atol: float, rtol: float = None):
    """(max |out - ref|, largest share of the limit used); raises unless
    |out - ref| <= atol + rtol |ref| everywhere (rtol = atol when not given)."""
    rtol = atol if rtol is None else rtol
    d, r = (out.float() - ref.float()).abs(), ref.float().abs()
    worst = float((d / (atol + rtol * r)).max())
    if worst > 1.0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version, max |err| "
                             f"{float(d.max()):.3e}, {worst:.2f}x the limit (atol {atol}, rtol {rtol})")
    return float(d.max()), worst


def assert_bf16(name: str, out, ref):
    return assert_close(name, out, ref, BF16_ATOL, BF16_RTOL)


BF16_LIMIT = f"atol{BF16_ATOL}+rtol{BF16_RTOL}"


# ----------------------------------------------------------------- phases
def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    line("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    per = _build.build_all()
    line("build", seconds=f"{time.perf_counter() - t0:.2f}",
         kernels=",".join(f"{k}:{v:.2f}s" for k, v in per.items()), dir=_build.BUILD_DIR)


def _flash_bound(B, Sq, Skv, H, KVH, D, q_offset, causal=True):
    pairs = sum(min(Skv, q_offset + i + 1) if causal else Skv for i in range(Sq))
    nbytes = 2 * (2 * B * Sq * H * D + 2 * B * Skv * KVH * D)  # q, o, k, v in bf16
    return bound_ms(nbytes, 4.0 * B * H * D * pairs)


def phase_flash():
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)

    rec = {}
    # serve path: one 128-token prompt of qwen3-14b (B 1, H 40, KVH 8, D 128), q_offset 0
    B, S, H, KVH, D = 1, 128, 40, 8, 128
    q, k, v = rand(B, S, H, D), rand(B, S, KVH, D), rand(B, S, KVH, D)
    out = flash_attention(q, k, v, causal=True)
    ref = flash_attention_plain(q, k, v, True, 0)
    rec["max_abs_err"], share = assert_bf16("flash main", out, ref)
    out32 = flash_attention(q.float(), k.float(), v.float(), causal=True)
    err32, _ = assert_close("flash main f32", out32, flash_attention_plain(q.float(), k.float(), v.float()), F32_TOL)
    rec["ms"] = time_ms(lambda: flash_attention(q, k, v, causal=True), 200)
    rec["plain_ms"] = time_ms(lambda: flash_attention_plain(q, k, v, True, 0), 50)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    rec["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True), 200)
    rec["bound_ms"], rec["bound_by"] = _flash_bound(B, S, S, H, KVH, D, 0)
    line("flash", case="main B1 S128 H40 KVH8 D128 bf16", max_abs_err=f"{rec['max_abs_err']:.3e}",
         tol=BF16_LIMIT, of_limit=f"{share:.3f}", f32_err=f"{err32:.3e}", f32_tol=F32_TOL, kernel_ms=f"{rec['ms']:.5f}",
         plain_ms=f"{rec['plain_ms']:.5f}", library_ms=f"{rec['library_ms']:.5f}",
         bound_ms=f"{rec['bound_ms']:.5f}", bound_by=rec["bound_by"])

    # ragged offset over a strided cache slice, as a prefill at pos > 0 reads it
    B2, Sq2, off2, Smax = 2, 77, 51, 144
    cache_k, cache_v = rand(B2, Smax, KVH, D), rand(B2, Smax, KVH, D)
    q2 = rand(B2, Sq2, H, D)
    kk, vv = cache_k[:, :off2 + Sq2], cache_v[:, :off2 + Sq2]
    err2, share2 = assert_bf16("flash ragged", flash_attention(q2, kk, vv, causal=True, q_offset=off2),
                        flash_attention_plain(q2, kk, vv, True, off2))
    line("flash", case=f"ragged B2 Sq{Sq2} q_offset{off2} strided-cache", max_abs_err=f"{err2:.3e}", tol=BF16_LIMIT,
         of_limit=f"{share2:.3f}")

    # one larger prefill: 4096 tokens
    SL = 4096
    qL, kL, vL = rand(1, SL, H, D), rand(1, SL, KVH, D), rand(1, SL, KVH, D)
    errL, shareL = assert_bf16("flash S4096", flash_attention(qL, kL, vL, causal=True),
                        flash_attention_plain(qL, kL, vL, True, 0))
    large = {"shape": "B1 S4096 H40 KVH8 D128 bf16", "max_abs_err": errL}
    large["ms"] = time_ms(lambda: flash_attention(qL, kL, vL, causal=True), 5, reps=3)
    large["plain_ms"] = time_ms(lambda: flash_attention_plain(qL, kL, vL, True, 0), 2, reps=3)
    qLt, kLt, vLt = qL.transpose(1, 2), kL.transpose(1, 2), vL.transpose(1, 2)
    large["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(qLt, kLt, vLt, is_causal=True, enable_gqa=True), 5, reps=3)
    large["bound_ms"], large["bound_by"] = _flash_bound(1, SL, SL, H, KVH, D, 0)
    rec["large"] = large
    line("flash", case=large["shape"], max_abs_err=f"{errL:.3e}", tol=BF16_LIMIT, of_limit=f"{shareL:.3f}",
         kernel_ms=f"{large['ms']:.4f}", plain_ms=f"{large['plain_ms']:.4f}",
         library_ms=f"{large['library_ms']:.4f}", bound_ms=f"{large['bound_ms']:.4f}",
         bound_by=large["bound_by"])
    del qL, kL, vL, qLt, kLt, vLt
    torch.cuda.empty_cache()
    return rec


def _decode_bound(B, H, KVH, D, lens_sum, NB):
    nbytes = 2 * 2 * B * H * D + 2 * 2 * lens_sum * KVH * D + 4 * B * NB + 4 * B
    return bound_ms(nbytes, 4.0 * H * D * lens_sum)


def _dense_sdpa_inputs(q, kp, vp, tables, lens):
    """Pre-gathered dense KV (B, KVH, T, D) and a (B,1,1,T) mask for SDPA."""
    import torch

    B, NB = tables.shape
    _, page, KVH, D = kp.shape
    T = NB * page
    kd = kp[tables.long()].reshape(B, T, KVH, D).transpose(1, 2).contiguous()
    vd = vp[tables.long()].reshape(B, T, KVH, D).transpose(1, 2).contiguous()
    mask = (torch.arange(T, device=q.device)[None, :] < lens[:, None].long())[:, None, None, :]
    return q[:, :, None, :], kd, vd, mask


def phase_paged_decode():
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import paged_decode, paged_decode_ref
    from repro_torch.serving.paged_pool import PagedKVPool

    g = torch.Generator(device="cuda").manual_seed(1)
    dev = "cuda"

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)

    rec = {}
    # serve path: the dense cache of one 136-slot sequence viewed as 16-token pages
    H, KVH, D, page, Smax = 40, 8, 128, 16, 144
    NB = Smax // page
    kc, vc = rand(1, Smax, KVH, D), rand(1, Smax, KVH, D)
    kp, vp = kc.view(NB, page, KVH, D), vc.view(NB, page, KVH, D)
    tables = torch.arange(NB, dtype=torch.int32, device=dev).view(1, NB)
    q = rand(1, H, D)
    errs = []
    for n in range(129, 137):
        lens = torch.tensor([n], dtype=torch.int32, device=dev)
        errs.append(assert_bf16(f"paged_decode kv_len {n}", paged_decode(q, kp, vp, tables, lens),
                                 paged_decode_ref(q, kp, vp, tables, lens)))
    rec["max_abs_err"], share = (max(e) for e in zip(*errs))
    lens = torch.tensor([136], dtype=torch.int32, device=dev)
    err32, _ = assert_close("paged_decode f32", paged_decode(q.float(), kp.float(), vp.float(), tables, lens),
                         paged_decode_ref(q.float(), kp.float(), vp.float(), tables, lens), F32_TOL)
    rec["ms"] = time_ms(lambda: paged_decode(q, kp, vp, tables, lens), 200)
    rec["plain_ms"] = time_ms(lambda: paged_decode_ref(q, kp, vp, tables, lens), 50)
    sq, sk, sv, _ = _dense_sdpa_inputs(q, kp, vp, tables, lens)
    sk, sv = sk[:, :, :136].contiguous(), sv[:, :, :136].contiguous()
    rec["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(sq, sk, sv, enable_gqa=True), 200)
    rec["bound_ms"], rec["bound_by"] = _decode_bound(1, H, KVH, D, 136, NB)
    line("paged_decode", case="main B1 H40 KVH8 D128 page16 kv_len129..136 bf16",
         max_abs_err=f"{rec['max_abs_err']:.3e}", tol=BF16_LIMIT, of_limit=f"{share:.3f}",
         f32_err=f"{err32:.3e}", f32_tol=F32_TOL,
         kernel_ms=f"{rec['ms']:.5f}", plain_ms=f"{rec['plain_ms']:.5f}",
         library_ms=f"{rec['library_ms']:.5f}", bound_ms=f"{rec['bound_ms']:.5f}",
         bound_by=rec["bound_by"])

    # batch: 32 sequences, mixed kv_len up to 4096, shuffled tables, one kv_len = 0 row
    B, NBb = 32, 256
    P = B * NBb + 64
    kpb, vpb = rand(P, page, KVH, D), rand(P, page, KVH, D)
    tab = torch.randperm(P, generator=g, device=dev)[:B * NBb].to(torch.int32).view(B, NBb).contiguous()
    lensb = torch.randint(1, NBb * page + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    lensb[0] = NBb * page
    lensb[5] = 0
    qb = rand(B, H, D)
    outb = paged_decode(qb, kpb, vpb, tab, lensb)
    errb, shareb = assert_bf16("paged_decode batch", outb, paged_decode_ref(qb, kpb, vpb, tab, lensb))
    if outb[5].abs().max().item() != 0.0:
        raise AssertionError("paged_decode: a kv_len = 0 row must give zeros")
    lens_sum = int(lensb.sum())
    large = {"shape": "B32 H40 KVH8 D128 page16 kv_len<=4096 shuffled bf16", "max_abs_err": errb}
    large["ms"] = time_ms(lambda: paged_decode(qb, kpb, vpb, tab, lensb), 50)
    large["plain_ms"] = time_ms(lambda: paged_decode_ref(qb, kpb, vpb, tab, lensb), 5, reps=3)
    sq, sk, sv, mask = _dense_sdpa_inputs(qb, kpb, vpb, tab, lensb)
    large["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask, enable_gqa=True), 50)
    large["bound_ms"], large["bound_by"] = _decode_bound(B, H, KVH, D, lens_sum, NBb)
    rec["large"] = large
    line("paged_decode", case=large["shape"], max_abs_err=f"{errb:.3e}", tol=BF16_LIMIT, of_limit=f"{shareb:.3f}",
         zero_row="zeros", kernel_ms=f"{large['ms']:.4f}", plain_ms=f"{large['plain_ms']:.4f}",
         library_ms=f"{large['library_ms']:.4f}", bound_ms=f"{large['bound_ms']:.4f}",
         bound_by=large["bound_by"], kv_tokens=lens_sum)
    del kpb, vpb, sk, sv
    torch.cuda.empty_cache()

    # staging check: promote blocks into a pool on the card, decode per layer,
    # compare with the plain version and with dense attention per sequence
    rng = torch.Generator().manual_seed(0)
    L, KVHs, Ds, pg, Hs = 2, 2, 32, 4, 4
    pool = PagedKVPool(16, pg, L, KVHs, Ds, device=dev)
    seqs = {10: 7, 11: 10}
    dense = {}
    for sid, n_tok in seqs.items():
        pool.alloc(sid, -(-n_tok // pg))
        kb = torch.randn((L, n_tok, KVHs, Ds), generator=rng).to(torch.float16)
        vb = torch.randn((L, n_tok, KVHs, Ds), generator=rng).to(torch.float16)
        dense[sid] = (kb, vb)
        for off in range(0, n_tok, pg):
            end = min(off + pg, n_tok)
            pool.stage_block(sid, off, kb[:, off:end], vb[:, off:end])
        assert pool.seq_len(sid) == n_tok
    sids = list(seqs)
    tabs, lens_s = pool.block_tables(sids), pool.kv_lens(sids)
    qs = torch.randn((len(sids), Hs, Ds), generator=rng).to(dev)
    worst = 0.0
    for layer in range(L):
        kl, vl = (t.float() for t in pool.layer_view(layer))
        outs = paged_decode(qs, kl, vl, tabs, lens_s)
        worst = max(worst, assert_close("pool staging", outs, paged_decode_ref(qs, kl, vl, tabs, lens_s), 2e-5)[0])
        for i, sid in enumerate(sids):
            kd, vd = (t[layer].float().to(dev) for t in dense[sid])
            qg = qs[i].reshape(KVHs, Hs // KVHs, Ds)
            p = torch.softmax(torch.einsum("kgd,tkd->kgt", qg, kd) / Ds**0.5, dim=-1)
            o = torch.einsum("kgt,tkd->kgd", p, vd).reshape(Hs, Ds)
            assert_close("pool vs dense", outs[i], o, 2e-3)
    line("paged_decode", case="pool staging L2 KVH2 D32 page4 f32", max_abs_err=f"{worst:.3e}", tol=2e-5,
         dense_tol=2e-3)
    return rec


def phase_serve(seed):
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.serve_e2e import main as serve_main
    from repro_torch.models import api
    from repro_torch.models.common import count_params, tree_leaves

    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed, "cuda")
    torch.cuda.synchronize()
    line("serve", init_params_s=f"{time.perf_counter() - t0:.2f}", params=count_params(params),
         layers=cfg.n_layers, d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
         d_ff=cfg.d_ff, vocab=cfg.vocab_size,
         weights_gb=f"{sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9:.2f}")
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = serve_main(arch=ARCH, device="cuda", seed=seed, params=params)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    wall = time.perf_counter() - t0

    for st in res["stages"]:
        line("serve", stage=st["stage"], expect_hit=st["expect_hit"], hit=f"{st['hit']:.4f}",
             ttft_ms=f"{st['ttft_s'] * 1e3:.3f}", compute_ms=f"{st['compute_s'] * 1e3:.3f}",
             io_ms=f"{st['io_s'] * 1e3:.3f}")
        if st["expect_hit"] > 0 and st["hit"] <= 0:
            raise AssertionError(f"stage {st['stage']} expected hits but reused nothing")
    want_flash = cfg.n_layers * res["prefills"]
    want_decode = cfg.n_layers * res["decode_steps"]
    if counts["flash"] != want_flash or counts["paged_decode"] != want_decode:
        raise AssertionError(f"launch counts {counts}, expected flash {want_flash} "
                             f"({cfg.n_layers} per prefill x {res['prefills']}) and paged_decode "
                             f"{want_decode} ({cfg.n_layers} per token x {res['decode_steps']})")
    if not bool(torch.isfinite(res["decode_logits"]).all()):
        raise AssertionError("non-finite decode logits")
    line("serve", wall_s=f"{wall:.2f}", prefills=res["prefills"], decoded=res["decoded"],
         decode_s=f"{res['decode_s']:.3f}", launches=json.dumps(counts).replace(" ", ""),
         peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", store_bytes=res["store_bytes"])
    return cfg, params, res, counts


def _host_ms(fn, reps: int = 5) -> float:
    """Median wall time of ``fn`` ended by a device synchronise."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_decode_check(cfg, params, res):
    """Feed the serve run's decode inputs again (teacher forcing) through the
    kernel path and through the plain attention versions; compare logits
    and argmax tokens.  Also times, warm, one 128-token prefill and the
    8-step decode on each path (host clock, synchronised)."""
    import torch

    from repro_torch.launch.serve_e2e import greedy_decode
    from repro_torch.models import api

    prompt, n, fed = res["prompt"], res["decode_steps"], res["decode_inputs"]
    plain_tokens, _, plain_logits = greedy_decode(cfg, params, prompt, n, "cuda",
                                                  plain_attention=True, inputs=fed)
    err = max_err(res["decode_logits"], plain_logits)
    scale = float(plain_logits.abs().max())
    agree = sum(a == b for a, b in zip(plain_tokens, res["decoded"])) / len(res["decoded"])
    line("decode-check", kernel_tokens=res["decoded"], plain_tokens=plain_tokens, agreement=f"{agree:.3f}",
         logits_max_abs_err=f"{err:.4e}", max_abs_logit=f"{scale:.4f}",
         tol=f"{LOGIT_REL_TOL}*max|logit|={LOGIT_REL_TOL * scale:.4f}")
    if agree < MIN_TOKEN_AGREEMENT or err > LOGIT_REL_TOL * scale or not bool(torch.isfinite(plain_logits).all()):
        raise AssertionError("decode-check: the kernel path and the plain path disagree")

    toks = torch.tensor(prompt, dtype=torch.int64, device="cuda")[None, :]
    timing = {}
    for label, plain in (("kernel", False), ("plain", True)):
        pfn = api.prefill_fn(cfg, plain)

        def prefill():
            with torch.inference_mode():
                pfn(params, {"tokens": toks}, api.init_cache(cfg, 1, len(prompt), "cuda"), 0)

        prefill()
        timing[f"{label}_prefill_ms"] = _host_ms(prefill)
        total = _host_ms(lambda: greedy_decode(cfg, params, prompt, n, "cuda", plain, fed))
        timing[f"{label}_decode_ms_per_token"] = (total - timing[f"{label}_prefill_ms"]) / n
    line("decode-check", **{k: f"{v:.3f}" for k, v in timing.items()})
    profile_prefill(cfg, params, toks)


def profile_prefill(cfg, params, toks):
    """torch.profiler over one warm kernel-path prefill: device busy time
    (sum of kernel times, one stream) against the synchronised wall time,
    and the kernels that take it.  The table goes to chiprun_out/."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import api

    pfn = api.prefill_fn(cfg)

    def prefill():
        with torch.inference_mode():
            pfn(params, {"tokens": toks}, api.init_cache(cfg, 1, toks.shape[1], "cuda"), 0)

    prefill()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "profile_prefill.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=30))
    line("profile", what="one warm 128-token prefill, kernel path", wall_ms=f"{wall_ms:.3f}",
         device_busy_ms=f"{busy_ms:.3f}", idle_share=f"{max(0.0, 1 - busy_ms / wall_ms):.3f}",
         top=";".join(f"{e.key[:40]}:{e.self_device_time_total / 1e3:.3f}ms" for e in top))


def kernels_line(flash, decode, counts):
    entries = []
    for name, rec, src, rep in (
        ("flash", flash, "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention/flash_attention.py:61"),
        ("paged_decode", decode, "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
         "src/repro/kernels/decode_attention/decode_attention.py:65"),
    ):
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": counts[name], "max_abs_err": rec["max_abs_err"], "tol": BF16_LIMIT,
            "ms": rec["ms"], "kernel_ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "large": rec["large"],
        })
    return {"kernels": entries}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails when the repository is not beside this file)

    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    flash = phase_flash()
    decode = phase_paged_decode()
    cfg, params, res, counts = phase_serve(SEED)
    phase_decode_check(cfg, params, res)
    print(json.dumps(kernels_line(flash, decode, counts)), flush=True)
    print(f"total_s={time.perf_counter() - t_start:.1f} card={smi}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
