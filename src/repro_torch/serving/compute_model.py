"""Calibrated TTFT compute model.

The paper's TTFT has two components, accounted separately:

  * I/O — measured for real against the actual disk backends.
  * compute — either measured (a real prefill through the engine's
    ``real_prefill`` hook) or modeled: the analytic FLOPs of the prefill
    over an assumed device rate (the paper's A30, 165 TFLOP/s bf16 dense at
    ~60 % prefill MFU, or any target device).

``calibrate_host_flops`` grounds the model in a measurement: it times the
port's own prefill on the chosen device (the card unless the caller asks
for the CPU), captured as a CUDA graph on the card as the reference times
a jitted one, and returns the achieved FLOP/s.

The model covers segmented prefill: sequences longer than ``segment``
tokens prefill in chunks with per-segment scheduling overhead, matching the
paper's observation that long prompts pay extra scheduling/memory-management
cost under GPU memory pressure.
"""

from __future__ import annotations

import time
from dataclasses import dataclass


def prefill_flops(cfg, n_tokens: int, context: int = 0) -> float:
    """Analytic forward FLOPs to prefill ``n_tokens`` given ``context``
    already-cached tokens."""
    n = cfg.active_param_count()
    base = 2.0 * n * n_tokens
    if cfg.attention != "none" and cfg.family != "rwkv6":
        sites = cfg.n_layers if cfg.attn_every == 0 else cfg.n_layers // cfg.attn_every
        # causal attention over (context + position) keys
        total_kv = n_tokens * context + n_tokens * (n_tokens + 1) / 2
        base += 4.0 * sites * cfg.n_heads * cfg.d_head * total_kv
    return base


@dataclass
class ComputeModel:
    """TTFT compute estimator for one (model, device) pair."""

    cfg: object  # full ModelConfig
    device_flops: float = 165e12 * 0.6  # A30 bf16 at 60% prefill MFU
    segment: int = 2048  # segmented-prefill chunk (GPU memory pressure)
    segment_overhead_s: float = 0.008  # scheduler + memory mgmt per segment
    decode_tok_s: float = 0.02  # per output token (not in TTFT)

    def prefill_s(self, n_tokens: int, context: int = 0) -> float:
        if n_tokens <= 0:
            return 0.0
        segs = max(1, -(-n_tokens // self.segment))
        fl = prefill_flops(self.cfg, n_tokens, context)
        return fl / self.device_flops + segs * self.segment_overhead_s

    def ttft(self, prompt_len: int, reused: int, io_s: float) -> float:
        """TTFT = promotion I/O + compute for the non-reused suffix."""
        return io_s + self.prefill_s(prompt_len - reused, context=reused)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def calibrate_host_flops(smoke_cfg, n_tokens: int = 256, iters: int = 2, device="cuda",
                         seed: int = 0) -> float:
    """Achieved FLOP/s of a real prefill of ``smoke_cfg`` on ``device``:
    the prefill step captured (``repro_torch.graphs.capture``: a CUDA graph on
    the card, the step itself on the CPU), one warm-up call, then
    ``iters`` timed ones, each ended by a device synchronise.  The cache
    is allocated once and held, as the reference's is (a recurrent model
    then starts each prefill from the state the last one left: other
    values, the same work).  An encdec model encodes zero frames, as the
    reference's calibration does."""
    import torch

    from ..graphs import capture
    from ..models import api

    params = api.init_params(smoke_cfg, seed, device)
    pfn = api.prefill_fn(smoke_cfg)
    cache = api.init_cache(smoke_cfg, 1, n_tokens, device)
    inputs = {"tokens": torch.zeros((1, n_tokens), dtype=torch.int64, device=device)}
    if smoke_cfg.family == "encdec":
        inputs["frames"] = torch.zeros((1, smoke_cfg.enc_frames, smoke_cfg.d_model), dtype=torch.bfloat16,
                                       device=device)

    with torch.inference_mode():
        step = capture(lambda p, i, c: pfn(p, i, c, 0)[0], params, inputs, cache, held=(0, 2))
        step(params, inputs, cache)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            step(params, inputs, cache)
            _sync(device)
        dt = (time.perf_counter() - t0) / iters
    return prefill_flops(smoke_cfg, n_tokens) / max(dt, 1e-9)
