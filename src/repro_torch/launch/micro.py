"""Kernel micro-benchmarks (the reference's ``benchmarks/kernels_micro.py``),
at the reference's shapes, one case per kernel:

  kernel_hbm_bytes  the bytes the kernel moves by its design: each input
                    read once, each output written once (the reference's
                    formulas; scores, chunk states and splits stay on chip)
  oracle_hbm_bytes  the bytes its plain PyTorch version moves, counted op
                    by op on meta tensors by ``launch.cost`` (eager
                    PyTorch: one kernel an op, no fusion)
  bound_ms          max(kernel bytes / HBM_BW, flops / peak): the H100's
                    bf16 tensor-core peak for a bf16 kernel, its TF32 peak
                    for the f32 scans
  kernel_ms         on the card only: CUDA-graph replay, median of 5, and
                    ``share_of_bound`` = bound_ms / kernel_ms
  library_ms        on the card only, the same timer over one PyTorch call
                    of the same function on the same inputs, where there is
                    one (a yardstick: the port never calls it):
                    ``scaled_dot_product_attention`` for flash, and for
                    paged decode over the pages gathered beforehand into
                    dense K/V; ``torch.mul(q, s, out=out)`` for dequantize;
                    None where no one call computes it (quantize's absmax
                    and quantize, the scans)

The reference runs WKV and SSD in f32, and so does the port: both kernels
have an f32 instance.  The codec's dequantize, which the reference does
not run, is measured beside quantize.

``graph_ms`` and ``bound_ms`` are also ``chip_smoke.py``'s timer and bound.

    python -m repro_torch.launch.micro --device cpu    # the byte counts only
    python -m repro_torch.launch.micro --device cuda   # and each kernel's time on the card
"""

from __future__ import annotations

import argparse
import statistics
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

from ..kernels.decode_attention import paged_decode, paged_decode_ref
from ..kernels.flash_attention import flash_attention, flash_attention_plain
from ..kernels.kv_codec import dequantize, dequantize_ref, quantize, quantize_ref
from ..kernels.mamba2 import ssd, ssd_chunked_plain
from ..kernels.rwkv6 import wkv, wkv_chunked_plain
from ..models.common import resolve_device
from . import cost
from .mesh import HBM_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_TF32

META = torch.device("meta")
BF16, F32 = torch.bfloat16, torch.float32


def _oracle_bytes(fn: Callable, *args, **kwargs) -> float:
    """The plain version's traffic on meta tensors, by the cost counter."""
    return cost.count(fn, *args, **kwargs)[1].bytes


def graph_ms(fn: Callable, iters: int = 10, reps: int = 5) -> float:
    """Device ms per call: ``iters`` calls captured in one CUDA graph, the
    graph replayed ``reps`` times between CUDA events; the median per call.
    Replayed, the kernels run back to back, so the host's launch overhead
    (larger than a microsecond kernel) is not in the number.  Inputs stay in
    the 50 MB L2 between calls where they fit, as a serve step leaves the
    K/V it has just written."""
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


def bound_ms(nbytes: float, flops: float, flop_rate: float = PEAK_FLOPS_BF16):
    """(the least ms the card could take, "bytes" or "operations"): the
    larger of ``nbytes`` over HBM_BW and ``flops`` over ``flop_rate``."""
    t_bytes, t_ops = nbytes / HBM_BW, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _case(name: str, shape: str, dtype, kernel_bytes: float, flops: float, oracle: float, peak: float) -> Dict:
    ms, by = bound_ms(kernel_bytes, flops, peak)
    return {"name": name, "shape": shape, "dtype": str(dtype).replace("torch.", ""),
            "kernel_hbm_bytes": kernel_bytes, "oracle_hbm_bytes": oracle,
            "traffic_reduction": oracle / kernel_bytes, "flops": flops, "bound_ms": ms, "bound_by": by}


def _randn(shape, dtype, device, g):
    return torch.randn(shape, generator=g, device=device, dtype=F32).to(dtype)


# ------------------------------------------------------------------ cases
def flash_case(device, B=4, S=2048, H=16, KVH=4, D=128):
    q, kv = (B, S, H, D), (B, S, KVH, D)
    oracle = _oracle_bytes(flash_attention_plain, *(torch.empty(s, dtype=BF16, device=META) for s in (q, kv, kv)),
                           True, 0)
    kernel_bytes = (B * S * H * D + 2 * B * S * KVH * D + B * S * H * D) * 2  # q, k, v in; o out
    rec = _case("flash", f"B{B} S{S} H{H} KVH{KVH} D{D} causal", BF16, kernel_bytes,
                4.0 * B * H * D * S * (S + 1) / 2, oracle, PEAK_FLOPS_BF16)

    def run(g):
        q_, k_, v_ = (_randn(s, BF16, device, g) for s in (q, kv, kv))
        qt, kt, vt = (t.transpose(1, 2) for t in (q_, k_, v_))
        return (lambda: flash_attention(q_, k_, v_, causal=True),
                lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True))

    return rec, run


def paged_decode_case(device, B=64, H=32, KVH=8, D=128, page=64, NB=512):
    P = B * NB

    def inputs(dev, g=None):
        make = (lambda s: torch.empty(s, dtype=BF16, device=dev)) if g is None else \
            (lambda s: _randn(s, BF16, dev, g))
        tables = torch.arange(P, dtype=torch.int32, device=dev).view(B, NB)
        lens = torch.full((B,), NB * page, dtype=torch.int32, device=dev)
        return make((B, H, D)), make((P, page, KVH, D)), make((P, page, KVH, D)), tables, lens

    oracle = _oracle_bytes(paged_decode_ref, *inputs(META))
    # each mapped page read once, q in, o out
    kernel_bytes = (B * H * D + 2 * B * NB * page * KVH * D + B * H * D) * 2
    rec = _case("paged_decode", f"B{B} H{H} KVH{KVH} D{D} page {page}, {NB} pages a sequence", BF16,
                kernel_bytes, 4.0 * B * H * D * NB * page, oracle, PEAK_FLOPS_BF16)

    def run(g):
        args = inputs(device, g)
        q, kp, vp, tables = args[:4]  # every sequence's kv_len is its whole table: no mask
        kd, vd = (p[tables.long()].reshape(B, NB * page, KVH, D).transpose(1, 2).contiguous() for p in (kp, vp))
        return (lambda: paged_decode(*args),
                lambda: F.scaled_dot_product_attention(q[:, :, None], kd, vd, enable_gqa=True))

    return rec, run


def quantize_case(device, T=256, C=8192):
    oracle = _oracle_bytes(quantize_ref, torch.empty((T, C), dtype=BF16, device=META))
    rec = _case("quantize", f"{T} x {C}", BF16, T * C * 2 + T * C * 1 + C * 4, 0.0, oracle, PEAK_FLOPS_BF16)

    def run(g):
        x = _randn((T, C), BF16, device, g)
        return lambda: quantize(x), None

    return rec, run


def dequantize_case(device, T=256, C=8192):
    def inputs(dev, g=None):
        if g is None:
            return torch.empty((T, C), dtype=torch.int8, device=dev), torch.empty(C, dtype=F32, device=dev)
        q = torch.randint(-127, 128, (T, C), generator=g, device=dev, dtype=torch.int8)
        return q, torch.rand(C, generator=g, device=dev, dtype=F32)

    oracle = _oracle_bytes(dequantize_ref, *inputs(META), BF16)
    rec = _case("dequantize", f"{T} x {C} -> bf16", BF16, T * C * 1 + C * 4 + T * C * 2, 0.0, oracle,
                PEAK_FLOPS_BF16)

    def run(g):
        q, s = inputs(device, g)
        out = torch.empty((T, C), dtype=BF16, device=device)
        return lambda: dequantize(q, s, out_dtype=BF16), lambda: torch.mul(q, s, out=out)

    return rec, run


def wkv_case(device, B=8, H=32, S=4096, N=64, chunk=32):
    def inputs(dev, g=None):
        seq, hn, st = (B, H, S, N), (H, N), (B, H, N, N)
        if g is None:
            return [torch.empty(s, dtype=F32, device=dev) for s in (seq, seq, seq, seq, hn, st)]
        r, k, v = (_randn(seq, F32, dev, g) * 0.5 for _ in range(3))
        w = 0.5 + 0.5 * torch.rand(seq, generator=g, device=dev, dtype=F32)  # decays in (0.5, 1)
        return [r, k, v, w, _randn(hn, F32, dev, g) * 0.1, torch.zeros(st, dtype=F32, device=dev)]

    # the plain version in the kernel's own (B, S, H, N) layout, at its chunk
    oracle = _oracle_bytes(lambda r, k, v, w, u, s: wkv_chunked_plain(*(t.transpose(1, 2) for t in (r, k, v, w)),
                                                                      u, s, chunk), *inputs(META))
    # r/k/v/w in, y out, the state in and out once (it stays on chip across chunks)
    kernel_bytes = (4 * B * H * S * N + B * H * S * N + 2 * B * H * N * N) * 4
    flops = B * H * (S // chunk) * (4 * chunk * N * N + 2 * chunk * (chunk - 1) * N)
    rec = _case("wkv", f"B{B} H{H} S{S} N{N}, chunk {chunk}", F32, kernel_bytes, flops, oracle, PEAK_FLOPS_TF32)

    def run(g):
        args = inputs(device, g)
        return lambda: wkv(*args, chunk=chunk), None

    return rec, run


def ssd_case(device, B=8, S=4096, H=32, P=64, N=64, chunk=64):
    def inputs(dev, g=None):
        shapes = ((B, S, H, P), (B, S, N), (B, S, N), (B, S, H), (B, S, H), (B, H, P, N))
        if g is None:
            return [torch.empty(s, dtype=F32, device=dev) for s in shapes]
        x, bm, cm = (_randn(s, F32, dev, g) for s in shapes[:3])
        a = -torch.rand(shapes[3], generator=g, device=dev, dtype=F32)  # log-decays < 0
        dt = 0.1 * torch.rand(shapes[4], generator=g, device=dev, dtype=F32)
        return [x, bm, cm, a, dt, torch.zeros(shapes[5], dtype=F32, device=dev)]

    oracle = _oracle_bytes(ssd_chunked_plain, *inputs(META), chunk)
    # x/B/C/a/dt in, y out, the state in and out once (it stays on chip across chunks)
    kernel_bytes = (2 * B * S * H * P + 2 * B * S * N + 2 * B * S * H + 2 * B * H * P * N) * 4
    flops = B * H * (S // chunk) * (chunk * (chunk + 1) * (N + P) + 4 * chunk * P * N)
    rec = _case("ssd", f"B{B} S{S} H{H} P{P} N{N}, chunk {chunk}", F32, kernel_bytes, flops, oracle,
                PEAK_FLOPS_TF32)

    def run(g):
        args = inputs(device, g)
        return lambda: ssd(*args, chunk=chunk), None

    return rec, run


CASES = (flash_case, paged_decode_case, quantize_case, dequantize_case, wkv_case, ssd_case)


def run(device="cuda", seed: int = 0, verbose: bool = True) -> List[Dict]:
    """Every case's record; on a CUDA ``device`` also its kernel's time and
    its library call's (the inputs drawn from ``seed`` on the card, freed
    after each case).  On the CPU the byte counts only: the kernels run on
    the card."""
    dev = resolve_device(device)
    out = []
    for make in CASES:
        rec, build = make(dev)
        if dev.type == "cuda":
            g = torch.Generator(device=dev).manual_seed(seed)
            call, library = build(g)
            iters = 3 if rec["bound_ms"] > 1 else 10
            with torch.inference_mode():
                rec["kernel_ms"] = graph_ms(call, iters=iters)
                rec["library_ms"] = graph_ms(library, iters=iters) if library is not None else None
            rec["share_of_bound"] = rec["bound_ms"] / rec["kernel_ms"]
            del call, library
            torch.cuda.empty_cache()
        out.append(rec)
        if verbose:
            lib = rec.get("library_ms")
            t = (f" kernel {rec['kernel_ms']:.4f} ms = {rec['share_of_bound']:.2f} of bound, library "
                 f"{'none' if lib is None else f'{lib:.4f} ms'}" if "kernel_ms" in rec else "")
            print(f"{rec['name']:13s} {rec['shape']:44s} {rec['dtype']:8s} oracle {rec['oracle_hbm_bytes'] / 1e9:8.3f} GB "
                  f"-> kernel {rec['kernel_hbm_bytes'] / 1e9:7.3f} GB ({rec['traffic_reduction']:6.1f}x less), "
                  f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}){t}", flush=True)
    if verbose and dev.type != "cuda":
        print(f"[kernels-micro] on {dev}: byte counts only; the kernels' times come from --device cuda")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="Kernel micro-benchmarks at the reference's shapes")
    ap.add_argument("--device", default="cuda", help="cuda (bytes and the kernels' times) or cpu (bytes only)")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
