#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, in order, one line each:
  1. device        card name and power limit (nvidia-smi), torch and CUDA versions
  2. build         compile every kernel from the sources in the checkout (nvcc)
     design        which design each kernel runs, as its library reports
                   it: the attention kernels' (wgmma, mma.sync or FMA) and
                   paged decode's split count (n_splits x split_len) at three
                   shapes; the scans' product units (mma.sync and its bf16
                   pieces, or FMA register tiles), SSD's state-pass steps,
                   WKV's chunks per state group and each scan kernel's
                   blocks, at the path and S 4096
  3. flash         flash-attention kernel vs its plain version on the card, bf16
                   and f32, at the serve path's shape, zamba2's (H 32, KVH 32,
                   D 64), olmoe's (H 16, KVH 16, D 128), minicpm3's MLA
                   prefill (H 40, q/k head dim 96, v head dim 64),
                   glm4-9b's (H 32, KVH 2, D 128), chameleon-34b's (H 64,
                   KVH 8, D 128) and kimi-k2's (H 64, KVH 8, D 112),
                   ragged-offset cases over strided cache slices, and
                   4096-token prefills at qwen3-14b's, minicpm3's, zamba2's
                   and kimi-k2's head shapes (kimi-k2's also in f32), and
                   whisper-small's non-causal shapes through the full entry
                   point (encoder 1500 x 1500, prefill cross-attention
                   128 x 1500, H 12, D 64: a key count no block divides); device
                   times (CUDA-graph replay) of kernel, plain version and SDPA
                   (yardstick only: the port never calls it)
  4. paged_decode  paged decode kernel vs its plain version at the serve path's
                   shape, zamba2's, olmoe's, glm4-9b's (G 16), chameleon-34b's
                   (G 8) and kimi-k2's (G 8, D 112; kv_len 129..136, bf16
                   and f32), a batch
                   of 32 with mixed kv_len up to 4096 over shuffled tables and
                   one kv_len = 0 row, one 4096-token sequence (and one at
                   kimi-k2's shape, bf16 and f32), whisper-small's
                   decode cross-attention (kv_len 1500 over 94 pages); the paged-pool
                   staging check; times as above
  5. serve         full-width qwen3-14b through launch.serve_e2e.main: staged
                   workload -> ServingEngine -> CacheHierarchy -> 4-shard
                   ShardedKVBlockStore on disk, real prefill and greedy decode,
                   every prefill and decode step a captured CUDA graph
                   (repro_torch.graphs.capture, all captured before the
                   engine starts); hits exact per stage; launch counters
                   reset just before and read just after: a replay runs no
                   wrapper, so they count the captures' warm calls and the
                   launches recorded into each graph (gated exact), and
                   each step's replays are counted
  6. decode-check  the decoded tokens again through the plain attention versions
                   on the card (teacher-forced): token agreement and logit error;
                   warm prefill and decode times of both paths (eager); a
                   torch.profiler pass over one prefill (device busy time,
                   idle share); then one `steps` line:
     steps         (one line per family, printed by phases 6, 6b and 9-13)
                   the main path's captured greedy decode against the same
                   steps run eagerly through the kernels (tokens equal,
                   max |dlogit| <= 1 % of max |logit|); eager and graph warm
                   prefill ms and decode ms per token (host clock,
                   synchronised, median of 5), the graphs' prefill and
                   decode device ms (CUDA events), capture seconds and
                   graph pool MB,
                   device busy and idle share of one eager and one graph
                   prefill under torch.profiler; and, from a device trace
                   (torch.profiler) of one replay of every captured step
                   the main path ran, the kernel launches per replay
                   (gated exact, and equal to what the capture recorded),
                   times that step's replays on the main path: the main
                   path's launches on the card (flash 40 per prefill and
                   paged decode 40 per token for qwen3-14b, gated exact)
  6a. cluster      the serve phase's workload on its weights over a cache
                   cluster: launch.serve_e2e.main with a ClusterKVBlockStore
                   over 3 node processes (python -m
                   repro_torch.cluster.node: LSM, codec raw, 2 I/O
                   threads; node 0 with its HTTP metrics endpoint) at
                   replication 2, as examples/failover.py builds it; hits
                   exact per stage, launches and replays gated as phase
                   serve's (flash 40 per prefill, paged decode 40 per
                   token), every block the hook handed over in the warm-up
                   read back with get_many bit for bit; then the node
                   holding the first replica of the first corpus prompt is
                   SIGKILLed: every committed prefix probes as before, the
                   blocks read back bit for bit, a fresh engine with empty
                   device and host tiers serves 8 requests of a corpus
                   prompt's first 96 tokens and 32 fresh ones (hit exactly
                   0.75, all 96 tokens from the surviving replicas), a
                   scrape returns within 5 s with the victim down; the
                   victim respawns cold on its address, maintenance revives
                   it, a scrape is clean and node 0's endpoint serves
                   Prometheus text with the server's counters.  Printed:
                   TTFT, io and compute ms per stage beside phase serve's,
                   the bytes written to the nodes, failovers, RPCs and the
                   phase's seconds
  6b. glm4         full-width glm4-9b (40 layers, d 4096, 32 heads, 2 KV
                   heads) from seed 0 through launch.serve_e2e.main, the
                   serve phase's workload and gates (flash 40 per prefill,
                   paged decode 40 per token), then glm4-check: phase 6's
                   checks and its steps line
  6c. qwen2.5-32b, chameleon-34b, kimi-k2
                   the three configs first served on the card: qwen2.5-32b
                   (64 layers, d 5120, qkv bias; 65.5 GB of bf16 weights)
                   and chameleon-34b (48 layers, d 8192, QK-norm; 68.6 GB)
                   at full width and depth, kimi-k2 at full width and 1 of
                   61 layers (d 7168, 64 heads of 112, 384 experts top-8;
                   38.8 GB), one after another, each after a check that the
                   card holds under MEM_BEFORE_CELL_GB: glm4's phases, with
                   kimi-k2's decode check on the kernel path's routing (as
                   phase olmoe's); each cell's decode ms a token against
                   the bound of reading its weights once (kimi-k2's also
                   against the weights its top-8 experts need), kimi-k2's
                   dispatch buffer, its zero rows and the expert products'
                   ms in one prefill; peak memory and seconds
  7. wkv           RWKV6 WKV kernel vs its chunked plain version on the card, f32
                   arithmetic: the rwkv6 path's shape (model layout, chunk 16,
                   the model's decay, so the log-decay clamp acts), a ragged S
                   with carried state, S 4096, the (B,H,S,N) op at chunk 32,
                   and against the sequential oracle where the clamp is idle;
                   device times of kernel and plain version, the bound and the
                   time as a multiple of it
  8. ssd           the same for the Mamba-2 SSD kernel: zamba2's shape at the
                   model's chunk of 256, a ragged S, S 4096, the op at chunk 64
  9. rwkv6         full-width rwkv6-1.6b from seed 0: a 128-token prompt
                   prefilled and 8 tokens decoded greedily through
                   launch.serve_e2e.greedy_decode, launch counters reset just
                   before and read just after (wkv 24 per prefill, none per
                   token); the same tokens again through the plain versions
                   (teacher-forced); state chaining (64 + 64 tokens against
                   128 at once); warm prefill and decode times of both paths;
                   a torch.profiler pass over one prefill
 10. zamba2        the same for full-width zamba2-1.2b (ssd 38 and flash 7
                   per prefill, paged_decode 7 per token)
 11. olmoe         the same for full-width olmoe-1b-7b, 64 experts top-8 (flash
                   16 per prefill, paged_decode 16 per token), and the count of
                   top-k routing choices that differ between the two paths
 12. minicpm3      the same for full-width minicpm3-4b, MLA (flash 62 per
                   prefill at q/k head dim 96 and v head dim 64; decode is the
                   absorbed plain-torch path, no launch)
 13. whisper       the same for full-width whisper-small, encoder-decoder, on
                   1500 stub frames drawn from the seed (flash 36 per
                   prefill: 12 encoder, 12 decoder self, 12 cross; paged_decode
                   24 per token: 12 self, 12 over the cross cache), with the
                   encoder's time beside the prefill's
 14. kv_codec      the int8 codec's entry points, quantize and dequantize, over
                   the float16 KV blocks of one full-width qwen3-14b prefill
                   (8 of 16 x 81920, as the serve hook hands them to the store)
                   and a 16 x 17856 slab of full-width minicpm3-4b's latent
                   cache (c and kr of 62 layers, a ragged channel edge), launch
                   counters reset just before and read just after; both
                   kernels held against their plain versions and the host codec
                   (core/codec.py) there, on the reference kernel test's shapes,
                   a zero channel and a 4096 x 8192 case (there bit for bit);
                   the plan each kernel launches (one pass or split-T,
                   slabs, vector width); device times, with torch.mul(q, s,
                   out=out) beside dequantize (yardstick only)
 14b. adamw       the fused AdamW's three kernels (kernels/adamw: sq_norm,
                   factored_stats, adamw_update) against their plain
                   versions on the card, on the three optimizer paths (f32
                   moments; bf16 m; bf16 m and a factored v) at qwen3-14b's
                   full-width leaves (one block's wq, w_down, attn_norm, the
                   final norm, lm_head 5120 x 151936) from a state at step
                   7, the clip acting (the norm within 1e-12, f32 state
                   within rtol 1e-6, p and m within one bf16 step); each
                   kernel's device time at lm_head (CUDA-graph replay)
                   against its bound, its plain version, and one PyTorch
                   call where there is one (torch._fused_adamw_ on the f32
                   path, torch.linalg.vector_norm beside sq_norm:
                   yardsticks only, the port never calls them)
 15. train         the port's training path, in four parts: bf16 gradients
                   of qwen3-14b at full width, 2 layers, against those of an
                   f32 copy of the weights, leaf by leaf, and the
                   embedding's backward in bf16; one AdamW step on the card
                   (the fused kernels) against the CPU on one block's
                   full-width leaves, f32 moments and bf16 m with a
                   factored v; then, launch counters reset just before and
                   read just after, the main path: 4 train steps of
                   qwen3-14b at full width, 8 of 40 layers (SyntheticLM
                   batches of 8 x 128 from seed 0, the loop's default
                   optimizer), each with its loss, grad norm, lr, step ms,
                   forward+backward and optimizer ms (CUDA events) beside
                   the optimizer's bound, tokens/s, model-FLOP share and
                   peak memory, a forward through the kernels under grad
                   that must raise, a profile of one more step; the same 5
                   steps from the same state through the step captured as
                   one CUDA graph as training/loop.train captures it (2
                   warm calls, a capture, 3 replays), gated equal bit for
                   bit in losses and every parameter, then 3 replays timed
                   (host clock and CUDA events) and one profiled (busy and
                   idle share, the graph's pool, its launches per replay
                   from the device trace: sq_norm and adamw_update 14
                   each, gated); two steps with bf16 m and a factored v;
                   the launches gated exact (sq_norm and adamw_update 14 a
                   step, factored_stats 13 a factored step:
                   train_launches); and examples/train_smoke_torch.py
                   --simulate-crash on the card in a subprocess
                   (deterministic algorithms), whose losses after the resume
                   must replay the uninterrupted run's
 16. distributed   the distributed layer (launch counters reset at its
                   start read 0 at its end in this process; the loop's
                   subprocess launches the optimizer's kernels exactly as
                   its 4 steps' leaves give them), with
                   the train phase's state freed: (a) an NCCL process group
                   of world size 1 over an in-process store, the (1, 1)
                   smoke mesh on the card, and full 40-layer qwen3-14b's
                   per-card GB of params and f32 AdamW state on the (16, 16)
                   mesh, reckoned from shard_slices (a count); (b) one
                   full-width qwen3-14b forward and backward (8 of 40
                   layers, 4.20 B bf16 gradient entries) through
                   compress_grads and the all-reduce over NCCL, leaf by leaf,
                   gated (|dequant(q) - (g + e)| <= scale/2 per entry, the
                   new residual g + e - dequant(q) bit for bit, the reduced
                   gradient dequant(q) bit for bit at world size 1), with
                   compress and all-reduce ms (CUDA events) beside their
                   bound (11 and 5 bytes an entry) and their share of the
                   train step; (c) 4 gloo ranks on the one card (spawned):
                   the compressed all-reduce of small gradients on CUDA
                   tensors equals the same on CPU tensors bit for bit; (d)
                   gpipe at one stage over NCCL, equal to the stage
                   function bit for bit; in a subprocess with deterministic
                   algorithms, the non-distributed loop and launch/train.main
                   --data 1 on full-width qwen3-14b (8 layers, 2 steps),
                   losses bit for bit, and the second run's checkpoint
                   restored under the (1, 1) mesh's shardings, each leaf
                   bit for bit the file's; the group destroyed at the end
 17. tensor-parallel  tensor parallelism over `model` (launch counters
                   reset at its start read 0 at its end in this process;
                   each rank and the --model 1 run launch the optimizer's
                   kernels exactly as their 2 launcher steps give them): (a)
                   full-width qwen3-14b, 2 of 40 layers, on an f32 copy of
                   the seed's weights: one process's loss and gradients
                   (make_grad_fn, to a file), then 2 spawned gloo ranks
                   on CUDA tensors at (data 1, model 2) (split over KV
                   heads: 20 q / 4 KV heads, 8704 hidden, 75968
                   vocabulary columns a rank), each rank's loss and every
                   gradient leaf gated against one process's (rtol 1e-5,
                   atol = rtol 1e-4), each step's ms and the gradient
                   sum over model alone; (c) on the same ranks, the
                   same model and batch with remat and seq_shard on (the
                   residual stream split over sequence: each rank holds
                   64 of the 128 rows between blocks, all-gathers where a
                   split begins, reduce-scatters where it ends), gated
                   against the same one-process file at (a)'s
                   tolerances, with its step ms, the collective bytes by
                   kind each rank sent and its peak allocated GB beside
                   the same step with seq_shard off, then lower_cell's
                   predicted temp and peak bytes for the train step at
                   (1, 2) (bf16, AdamW; counts, not measurements); (b)
                   launch/train.main --full --layers 2 --data 1 --model 2
                   on the same two ranks in bf16 (seq_shard off, as the
                   reference's launcher runs), its 2 losses against the
                   --model 1 run's in a fresh process (rtol 1e-3,
                   TP_LAUNCH_RTOL's reason).  Gloo stages every
                   collective through host memory, so its times say
                   nothing of NVLink
 18. dryrun        the dry run (launch.steps.lower_cell: each step traced on
                   meta tensors in this process under the cost counter,
                   launch/cost.py; no device) beside this run's own
                   measurements: (a) qwen3-14b's serve-shape prefill (B 1,
                   S 128) and decode (B 1, kv 136) at full width at mesh
                   (1, 1), FLOPs, bytes and roofline terms, and each term's
                   share of phase serve's graph device ms; (b) the train
                   cell (8 of 40 layers, B 8 x S 128) against phase train's
                   step ms; the counter's matmul FLOPs for one eager
                   plain-path prefill on the card against torch.profiler's
                   with_flops total (gated within 1 %); (c) qwen3-14b x
                   train_4k and glm4-9b x decode_32k at full width on the
                   (16, 16) mesh through launch/dryrun.py in subprocesses,
                   each record printed (gated ok, FLOPs and bytes > 0),
                   and the train record's seq_shard, temp and peak bytes
                   and model-axis collective bytes by kind beside the
                   counts of the whole-stream step (79.45 GB, 80.03 GB,
                   325.7 GB of all-reduce; DRYRUN_WHOLE_STREAM);
                   (d) phase 6c's cells at (a)'s shapes, each step's
                   predicted peak bytes beside its phase's measured peak
                   and the card's memory (printed, not gated).
                   Decode's bytes gated within 1.0-1.25x of what a decode
                   step must read (every parameter but the embedding table,
                   plus the cached tokens' K/V)
 19. kernels-micro launch/micro.py on the card: each kernel at the
                   reference's micro shapes (flash B4 S2048 H16 KVH4 D128,
                   paged decode B64 H32 KVH8 D128 page 64 x 512 pages,
                   quantize and dequantize 256 x 8192, WKV B8 H32 S4096 N64
                   f32, SSD B8 S4096 H32 P64 N64 f32): bytes by design,
                   its plain version's bytes (the cost counter on meta),
                   bound, kernel ms and library ms (CUDA-graph replay,
                   median of 5; SDPA for flash and paged decode,
                   torch.mul for dequantize, none for the others)
 20. kernels       one JSON line describing the nine kernels: `launches` is
                   the wrappers' count over the main paths' runs (eager
                   launches and launches recorded into graphs at capture;
                   flash and paged decode summed over the five serve paths,
                   the cluster's among them, `by_path` each one's share;
                   the fused AdamW's over phase train's main path),
                   `replayed_launches` the launches the main paths' graph
                   replays ran on the card, from the device trace

Every phase runs on every call.  Any failed phase raises and the exit code
is nonzero.  The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the rest
of the repository beside this file, the script exits nonzero and prints no
result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

from repro_torch.launch.mesh import PEAK_FLOPS_BF16 as BF16_FLOP_PER_S  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_TF32 as TF32_FLOP_PER_S  # noqa: E402  (the scans' f32 work)
from repro_torch.kernels import TRACE_SYMBOLS  # noqa: E402
from repro_torch.launch.micro import bound_ms, graph_ms  # noqa: E402  (CUDA-graph timer, the card's bound)
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
# the reference kernel tests' own tolerances (tests/test_kernels.py:104,141),
# atol = rtol: kernel and plain version do the same f32 operations, the
# cumulative log-decay in the same order, the other sums in another order
WKV_TOL = 3e-4
SSD_TOL = 4e-4
LOGIT_REL_TOL = 0.05  # decode-check: max |dlogit| <= 5% of max |logit|
# the recurrent models on an f32 copy of their weights: the readings were
# 2.8e-5 (rwkv6) and 2.9e-6 (zamba2) of max |logit| kernel vs plain, and
# 1.7e-4 and 6.4e-6 for chained prefill (PERF.md, Findings); 1 % leaves room
# for another card and summation order and still fails a dropped chunk
F32_LOGIT_REL_TOL = 0.01
MIN_TOKEN_AGREEMENT = 7 / 8  # a near-tie may flip one argmax


def line(phase: str, **kv) -> None:
    body = " ".join(f"{k}={v}" for k, v in kv.items())
    print(f"[{phase}] {body}", flush=True)


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
    import torch

    from repro_torch.kernels import _build, decode_attention, flash_attention, mamba2, rwkv6

    t0 = time.perf_counter()
    per = _build.build_all()
    line("build", seconds=f"{time.perf_counter() - t0:.2f}",
         kernels=",".join(f"{k}:{v:.2f}s" for k, v in per.items()), dir=_build.BUILD_DIR)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {label: "x".join(map(str, decode_attention.split_plan(B, 8, NB * 16, sms)))
             for label, B, NB in (("serve", 1, 9), ("batch32", 32, 256), ("one4096", 1, 256))}
    # the designs as the built libraries report them
    line("design", flash_bf16=flash_attention.design(torch.bfloat16), flash_f32=flash_attention.design(torch.float32),
         paged_decode_bf16=decode_attention.design(torch.bfloat16),
         paged_decode_f32=decode_attention.design(torch.float32),
         paged_decode_splits=f"sms{sms}," + ",".join(f"{k}={v}" for k, v in plans.items()))
    bf16, f32 = torch.bfloat16, torch.float32
    line("design", wkv_bf16=rwkv6.design(bf16, 1, 32, 128, 64), wkv_f32=rwkv6.design(f32, 1, 32, 128, 64),
         wkv_bf16_S4096=rwkv6.design(bf16, 1, 32, 4096, 64))
    line("design", ssd_bf16=mamba2.design(bf16, 1, 128, 64, 64, 64), ssd_f32=mamba2.design(f32, 1, 128, 64, 64, 64),
         ssd_bf16_S4096=mamba2.design(bf16, 1, 4096, 64, 64, 64))


def _flash_bound(B, Sq, Skv, H, KVH, D, q_offset, causal=True, Dv=None):
    """q and k of head dim D, v and o of head dim Dv (D when not given), bf16."""
    Dv = D if Dv is None else Dv
    pairs = sum(min(Skv, q_offset + i + 1) if causal else Skv for i in range(Sq))
    nbytes = 2 * (B * Sq * H * (D + Dv) + B * Skv * KVH * (D + Dv))  # q, o, k, v
    return bound_ms(nbytes, 2.0 * B * H * (D + Dv) * pairs)


def phase_flash():
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_full, flash_attention_plain

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
    rec["ms"] = graph_ms(lambda: flash_attention(q, k, v, causal=True), 200)
    rec["plain_ms"] = graph_ms(lambda: flash_attention_plain(q, k, v, True, 0), 50)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    rec["library_ms"] = graph_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True), 200)
    rec["bound_ms"], rec["bound_by"] = _flash_bound(B, S, S, H, KVH, D, 0)
    line("flash", case="main B1 S128 H40 KVH8 D128 bf16", max_abs_err=f"{rec['max_abs_err']:.3e}",
         tol=BF16_LIMIT, of_limit=f"{share:.3f}", f32_err=f"{err32:.3e}", f32_tol=F32_TOL, kernel_ms=f"{rec['ms']:.5f}",
         plain_ms=f"{rec['plain_ms']:.5f}", library_ms=f"{rec['library_ms']:.5f}",
         bound_ms=f"{rec['bound_ms']:.5f}", bound_by=rec["bound_by"])

    # zamba2 path: the shared attention block's 128-token prompt (B 1, H 32, KVH 32, D 64)
    Hz, KVHz, Dz = 32, 32, 64
    qz, kz, vz = rand(B, S, Hz, Dz), rand(B, S, KVHz, Dz), rand(B, S, KVHz, Dz)
    errz, sharez = assert_bf16("flash zamba2", flash_attention(qz, kz, vz, causal=True),
                               flash_attention_plain(qz, kz, vz, True, 0))
    errz32, _ = assert_close("flash zamba2 f32", flash_attention(qz.float(), kz.float(), vz.float(), causal=True),
                             flash_attention_plain(qz.float(), kz.float(), vz.float()), F32_TOL)
    rec["max_abs_err"] = max(rec["max_abs_err"], errz)
    qzt, kzt, vzt = qz.transpose(1, 2), kz.transpose(1, 2), vz.transpose(1, 2)
    boundz = _flash_bound(B, S, S, Hz, KVHz, Dz, 0)
    line("flash", case=f"zamba2 B{B} S{S} H{Hz} KVH{KVHz} D{Dz} bf16", max_abs_err=f"{errz:.3e}", tol=BF16_LIMIT,
         of_limit=f"{sharez:.3f}", f32_err=f"{errz32:.3e}", f32_tol=F32_TOL,
         kernel_ms=f"{graph_ms(lambda: flash_attention(qz, kz, vz, causal=True), 200):.5f}",
         plain_ms=f"{graph_ms(lambda: flash_attention_plain(qz, kz, vz, True, 0), 50):.5f}",
         library_ms=f"{graph_ms(lambda: F.scaled_dot_product_attention(qzt, kzt, vzt, is_causal=True), 200):.5f}",
         bound_ms=f"{boundz[0]:.5f}", bound_by=boundz[1])

    # olmoe-1b-7b, minicpm3-4b (MLA), glm4-9b (G 16), chameleon-34b (G 8)
    # and kimi-k2 (G 8 at head dim 112): their 128-token prompts
    for label, Hm, KVHm, Dm, Dvm in (("olmoe", 16, 16, 128, 128), ("minicpm3", 40, 40, 96, 64),
                                     ("glm4", 32, 2, 128, 128), ("chameleon", 64, 8, 128, 128),
                                     ("kimi", 64, 8, 112, 112)):
        qm, km, vm = rand(B, S, Hm, Dm), rand(B, S, KVHm, Dm), rand(B, S, KVHm, Dvm)
        errm, sharem = assert_bf16(f"flash {label}", flash_attention(qm, km, vm, causal=True),
                                   flash_attention_plain(qm, km, vm, True, 0))
        errm32, _ = assert_close(f"flash {label} f32", flash_attention(qm.float(), km.float(), vm.float(), causal=True),
                                 flash_attention_plain(qm.float(), km.float(), vm.float()), F32_TOL)
        rec["max_abs_err"] = max(rec["max_abs_err"], errm)
        qmt, kmt, vmt = qm.transpose(1, 2), km.transpose(1, 2), vm.transpose(1, 2)
        boundm = _flash_bound(B, S, S, Hm, KVHm, Dm, 0, Dv=Dvm)
        rec[label] = {"shape": f"B{B} S{S} H{Hm} KVH{KVHm} D{Dm} Dv{Dvm} causal bf16", "max_abs_err": errm,
                      "ms": graph_ms(lambda: flash_attention(qm, km, vm, causal=True), 200),
                      "plain_ms": graph_ms(lambda: flash_attention_plain(qm, km, vm, True, 0), 50),
                      "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(
                          qmt, kmt, vmt, is_causal=True, enable_gqa=Hm != KVHm), 200),
                      "bound_ms": boundm[0], "bound_by": boundm[1]}
        line("flash", case=f"{label} B{B} S{S} H{Hm} KVH{KVHm} D{Dm} Dv{Dvm} bf16", max_abs_err=f"{errm:.3e}",
             tol=BF16_LIMIT, of_limit=f"{sharem:.3f}", f32_err=f"{errm32:.3e}", f32_tol=F32_TOL,
             kernel_ms=f"{rec[label]['ms']:.5f}", plain_ms=f"{rec[label]['plain_ms']:.5f}",
             library_ms=f"{rec[label]['library_ms']:.5f}", bound_ms=f"{boundm[0]:.5f}", bound_by=boundm[1])

    # MLA's chained prefill: q/k 96, v 64 read from strided cache slices at an offset
    Bm2, Sqm, offm, Smaxm = 2, 45, 83, 144
    ckm, cvm = rand(Bm2, Smaxm, 40, 96), rand(Bm2, Smaxm, 40, 64)
    qm2 = rand(Bm2, Sqm, 40, 96)
    kk, vv = ckm[:, :offm + Sqm], cvm[:, :offm + Sqm]
    errm2, sharem2 = assert_bf16("flash minicpm3 ragged", flash_attention(qm2, kk, vv, causal=True, q_offset=offm),
                                 flash_attention_plain(qm2, kk, vv, True, offm))
    errm2_32, _ = assert_close("flash minicpm3 ragged f32",
                               flash_attention(qm2.float(), kk.float(), vv.float(), causal=True, q_offset=offm),
                               flash_attention_plain(qm2.float(), kk.float(), vv.float(), True, offm), F32_TOL)
    line("flash", case=f"minicpm3 ragged B{Bm2} Sq{Sqm} q_offset{offm} D96 Dv64 strided-cache", max_abs_err=f"{errm2:.3e}",
         tol=BF16_LIMIT, of_limit=f"{sharem2:.3f}", f32_err=f"{errm2_32:.3e}", f32_tol=F32_TOL)

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
    large["ms"] = graph_ms(lambda: flash_attention(qL, kL, vL, causal=True), 5, reps=3)
    large["plain_ms"] = graph_ms(lambda: flash_attention_plain(qL, kL, vL, True, 0), 2, reps=3)
    qLt, kLt, vLt = qL.transpose(1, 2), kL.transpose(1, 2), vL.transpose(1, 2)
    large["library_ms"] = graph_ms(
        lambda: F.scaled_dot_product_attention(qLt, kLt, vLt, is_causal=True, enable_gqa=True), 5, reps=3)
    large["bound_ms"], large["bound_by"] = _flash_bound(1, SL, SL, H, KVH, D, 0)
    rec["large"] = large
    line("flash", case=large["shape"], max_abs_err=f"{errL:.3e}", tol=BF16_LIMIT, of_limit=f"{shareL:.3f}",
         kernel_ms=f"{large['ms']:.4f}", plain_ms=f"{large['plain_ms']:.4f}",
         library_ms=f"{large['library_ms']:.4f}", bound_ms=f"{large['bound_ms']:.4f}",
         bound_by=large["bound_by"])
    del qL, kL, vL, qLt, kLt, vLt
    torch.cuda.empty_cache()

    # 4096-token prefills at minicpm3's MLA head dims, zamba2's G 1, D 64 and
    # kimi-k2's head dim 112 (its f32 instance held there too)
    for label, Hl, KVHl, Dl, Dvl, f32 in (("large_minicpm3", 40, 40, 96, 64, False),
                                          ("large_zamba2", 32, 32, 64, 64, False),
                                          ("large_kimi", 64, 8, 112, 112, True)):
        ql, kl, vl = rand(1, SL, Hl, Dl), rand(1, SL, KVHl, Dl), rand(1, SL, KVHl, Dvl)
        errl, sharel = assert_bf16(f"flash {label}", flash_attention(ql, kl, vl, causal=True),
                                   flash_attention_plain(ql, kl, vl, True, 0))
        f32_err = {}
        if f32:
            ql32, kl32, vl32 = ql.float(), kl.float(), vl.float()
            errl32, _ = assert_close(f"flash {label} f32", flash_attention(ql32, kl32, vl32, causal=True),
                                     flash_attention_plain(ql32, kl32, vl32, True, 0), F32_TOL)
            f32_err = {"f32_err": f"{errl32:.3e}", "f32_tol": F32_TOL}
            del ql32, kl32, vl32
        rec["max_abs_err"] = max(rec["max_abs_err"], errl)
        qlt, klt, vlt = ql.transpose(1, 2), kl.transpose(1, 2), vl.transpose(1, 2)
        boundl = _flash_bound(1, SL, SL, Hl, KVHl, Dl, 0, Dv=Dvl)
        rec[label] = {"shape": f"B1 S{SL} H{Hl} KVH{KVHl} D{Dl} Dv{Dvl} causal bf16", "max_abs_err": errl,
                      "ms": graph_ms(lambda: flash_attention(ql, kl, vl, causal=True), 5, reps=3),
                      "plain_ms": graph_ms(lambda: flash_attention_plain(ql, kl, vl, True, 0), 2, reps=3),
                      "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(
                          qlt, klt, vlt, is_causal=True, enable_gqa=Hl != KVHl), 5, reps=3),
                      "bound_ms": boundl[0], "bound_by": boundl[1]}
        line("flash", case=rec[label]["shape"], max_abs_err=f"{errl:.3e}", tol=BF16_LIMIT, of_limit=f"{sharel:.3f}",
             **f32_err, kernel_ms=f"{rec[label]['ms']:.4f}", plain_ms=f"{rec[label]['plain_ms']:.4f}",
             library_ms=f"{rec[label]['library_ms']:.4f}", bound_ms=f"{boundl[0]:.4f}", bound_by=boundl[1])
        del ql, kl, vl, qlt, klt, vlt
        torch.cuda.empty_cache()

    # whisper-small through the full entry point: every key visible, 1500
    # encoder frames (no multiple of the 64-key tile: the last holds 28);
    # the encoder's self-attention and prefill cross-attention
    Hw, Tw, Dw = 12, 1500, 64
    for label, Sqw in (("whisper_encoder", Tw), ("whisper_cross", PROMPT)):
        qw, kw, vw = rand(1, Sqw, Hw, Dw), rand(1, Tw, Hw, Dw), rand(1, Tw, Hw, Dw)
        errw, sharew = assert_bf16(f"flash {label}", flash_attention_full(qw, kw, vw),
                                   flash_attention_plain(qw, kw, vw, False, 0))
        errw32, _ = assert_close(f"flash {label} f32", flash_attention_full(qw.float(), kw.float(), vw.float()),
                                 flash_attention_plain(qw.float(), kw.float(), vw.float(), False, 0), F32_TOL)
        rec["max_abs_err"] = max(rec["max_abs_err"], errw)
        qwt, kwt, vwt = qw.transpose(1, 2), kw.transpose(1, 2), vw.transpose(1, 2)
        boundw = _flash_bound(1, Sqw, Tw, Hw, Hw, Dw, 0, causal=False)
        rec[label] = {"shape": f"B1 Sq{Sqw} Skv{Tw} H{Hw} KVH{Hw} D{Dw} non-causal bf16", "max_abs_err": errw,
                      "ms": graph_ms(lambda: flash_attention_full(qw, kw, vw), 50),
                      "plain_ms": graph_ms(lambda: flash_attention_plain(qw, kw, vw, False, 0), 5, reps=3),
                      "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(qwt, kwt, vwt), 50),
                      "bound_ms": boundw[0], "bound_by": boundw[1]}
        line("flash", case=rec[label]["shape"], max_abs_err=f"{errw:.3e}", tol=BF16_LIMIT, of_limit=f"{sharew:.3f}",
             f32_err=f"{errw32:.3e}", f32_tol=F32_TOL, kernel_ms=f"{rec[label]['ms']:.5f}",
             plain_ms=f"{rec[label]['plain_ms']:.5f}", library_ms=f"{rec[label]['library_ms']:.5f}",
             bound_ms=f"{boundw[0]:.5f}", bound_by=boundw[1])
        del qw, kw, vw, qwt, kwt, vwt
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
    rec["ms"] = graph_ms(lambda: paged_decode(q, kp, vp, tables, lens), 200)
    rec["plain_ms"] = graph_ms(lambda: paged_decode_ref(q, kp, vp, tables, lens), 50)
    sq, sk, sv, _ = _dense_sdpa_inputs(q, kp, vp, tables, lens)
    sk, sv = sk[:, :, :136].contiguous(), sv[:, :, :136].contiguous()
    rec["library_ms"] = graph_ms(lambda: F.scaled_dot_product_attention(sq, sk, sv, enable_gqa=True), 200)
    rec["bound_ms"], rec["bound_by"] = _decode_bound(1, H, KVH, D, 136, NB)
    line("paged_decode", case="main B1 H40 KVH8 D128 page16 kv_len129..136 bf16",
         max_abs_err=f"{rec['max_abs_err']:.3e}", tol=BF16_LIMIT, of_limit=f"{share:.3f}",
         f32_err=f"{err32:.3e}", f32_tol=F32_TOL,
         kernel_ms=f"{rec['ms']:.5f}", plain_ms=f"{rec['plain_ms']:.5f}",
         library_ms=f"{rec['library_ms']:.5f}", bound_ms=f"{rec['bound_ms']:.5f}",
         bound_by=rec["bound_by"])

    # zamba2's shared attention block (H 32, KVH 32, G 1, D 64), olmoe's
    # attention (H 16, KVH 16, G 1, D 128), glm4-9b's (H 32, KVH 2: G 16
    # query heads in one m16 tile), chameleon-34b's (H 64, KVH 8, G 8) and
    # kimi-k2's (G 8 at head dim 112) at decode
    for label, Hz, KVHz, Dz in (("zamba2", 32, 32, 64), ("olmoe", 16, 16, 128), ("glm4", 32, 2, 128),
                                ("chameleon", 64, 8, 128), ("kimi", 64, 8, 112)):
        kpz, vpz = (rand(1, Smax, KVHz, Dz).view(NB, page, KVHz, Dz) for _ in range(2))
        qz = rand(1, Hz, Dz)
        errs = []
        for n in range(129, 137):
            lens = torch.tensor([n], dtype=torch.int32, device=dev)
            errs.append(assert_bf16(f"paged_decode {label} kv_len {n}", paged_decode(qz, kpz, vpz, tables, lens),
                                    paged_decode_ref(qz, kpz, vpz, tables, lens)))
        errz, sharez = (max(e) for e in zip(*errs))
        rec["max_abs_err"] = max(rec["max_abs_err"], errz)
        errz32, _ = assert_close(f"paged_decode {label} f32",
                                 paged_decode(qz.float(), kpz.float(), vpz.float(), tables, lens),
                                 paged_decode_ref(qz.float(), kpz.float(), vpz.float(), tables, lens), F32_TOL)
        sq, sk, sv, _ = _dense_sdpa_inputs(qz, kpz, vpz, tables, lens)
        sk, sv = sk[:, :, :136].contiguous(), sv[:, :, :136].contiguous()
        boundz = _decode_bound(1, Hz, KVHz, Dz, 136, NB)
        rec[label] = {"shape": f"B1 H{Hz} KVH{KVHz} D{Dz} page16 kv_len136 bf16", "max_abs_err": errz,
                      "ms": graph_ms(lambda: paged_decode(qz, kpz, vpz, tables, lens), 200),
                      "plain_ms": graph_ms(lambda: paged_decode_ref(qz, kpz, vpz, tables, lens), 50),
                      "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(sq, sk, sv,
                                                                                   enable_gqa=Hz != KVHz), 200),
                      "bound_ms": boundz[0], "bound_by": boundz[1]}
        line("paged_decode", case=f"{label} B1 H{Hz} KVH{KVHz} D{Dz} page16 kv_len129..136 bf16",
             max_abs_err=f"{errz:.3e}", tol=BF16_LIMIT, of_limit=f"{sharez:.3f}", f32_err=f"{errz32:.3e}",
             f32_tol=F32_TOL, kernel_ms=f"{rec[label]['ms']:.5f}", plain_ms=f"{rec[label]['plain_ms']:.5f}",
             library_ms=f"{rec[label]['library_ms']:.5f}", bound_ms=f"{boundz[0]:.5f}", bound_by=boundz[1])

    # whisper-small's decode cross-attention: the cross cache of 1500
    # encoder frames at cache_len(1500) = 1504 slots, 94 pages, kv_len 1500;
    # the 4 pad slots hold values here, so one read unmasked would show
    Hw, Dw, NBw, Tw = 12, 64, 94, 1500
    kpw, vpw = rand(NBw, page, Hw, Dw), rand(NBw, page, Hw, Dw)
    tabw = torch.arange(NBw, dtype=torch.int32, device=dev).view(1, NBw)
    lensw = torch.tensor([Tw], dtype=torch.int32, device=dev)
    qw = rand(1, Hw, Dw)
    errw, sharew = assert_bf16("paged_decode whisper_cross", paged_decode(qw, kpw, vpw, tabw, lensw),
                               paged_decode_ref(qw, kpw, vpw, tabw, lensw))
    errw32, _ = assert_close("paged_decode whisper_cross f32",
                             paged_decode(qw.float(), kpw.float(), vpw.float(), tabw, lensw),
                             paged_decode_ref(qw.float(), kpw.float(), vpw.float(), tabw, lensw), F32_TOL)
    rec["max_abs_err"] = max(rec["max_abs_err"], errw)
    sq, sk, sv, _ = _dense_sdpa_inputs(qw, kpw, vpw, tabw, lensw)
    sk, sv = sk[:, :, :Tw].contiguous(), sv[:, :, :Tw].contiguous()
    boundw = _decode_bound(1, Hw, Hw, Dw, Tw, NBw)
    rec["whisper_cross"] = {"shape": f"B1 H{Hw} KVH{Hw} D{Dw} page16 kv_len{Tw} over {NBw} pages bf16",
                            "max_abs_err": errw,
                            "ms": graph_ms(lambda: paged_decode(qw, kpw, vpw, tabw, lensw), 200),
                            "plain_ms": graph_ms(lambda: paged_decode_ref(qw, kpw, vpw, tabw, lensw), 50),
                            "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(sq, sk, sv), 200),
                            "bound_ms": boundw[0], "bound_by": boundw[1]}
    line("paged_decode", case=rec["whisper_cross"]["shape"], max_abs_err=f"{errw:.3e}", tol=BF16_LIMIT,
         of_limit=f"{sharew:.3f}", f32_err=f"{errw32:.3e}", f32_tol=F32_TOL,
         kernel_ms=f"{rec['whisper_cross']['ms']:.5f}", plain_ms=f"{rec['whisper_cross']['plain_ms']:.5f}",
         library_ms=f"{rec['whisper_cross']['library_ms']:.5f}", bound_ms=f"{boundw[0]:.5f}", bound_by=boundw[1])
    del kpw, vpw, sk, sv

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
    large["ms"] = graph_ms(lambda: paged_decode(qb, kpb, vpb, tab, lensb), 50)
    large["plain_ms"] = graph_ms(lambda: paged_decode_ref(qb, kpb, vpb, tab, lensb), 5, reps=3)
    sq, sk, sv, mask = _dense_sdpa_inputs(qb, kpb, vpb, tab, lensb)
    large["library_ms"] = graph_ms(
        lambda: F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask, enable_gqa=True), 50)
    large["bound_ms"], large["bound_by"] = _decode_bound(B, H, KVH, D, lens_sum, NBb)
    rec["large"] = large
    line("paged_decode", case=large["shape"], max_abs_err=f"{errb:.3e}", tol=BF16_LIMIT, of_limit=f"{shareb:.3f}",
         zero_row="zeros", kernel_ms=f"{large['ms']:.4f}", plain_ms=f"{large['plain_ms']:.4f}",
         library_ms=f"{large['library_ms']:.4f}", bound_ms=f"{large['bound_ms']:.4f}",
         bound_by=large["bound_by"], kv_tokens=lens_sum)
    del kpb, vpb, sk, sv
    torch.cuda.empty_cache()

    # one 4096-token sequence (B 1): the case that splitting the KV range is for
    NBl = 256
    kpl, vpl = rand(NBl, page, KVH, D), rand(NBl, page, KVH, D)
    tabl = torch.randperm(NBl, generator=g, device=dev).to(torch.int32).view(1, NBl).contiguous()
    lensl = torch.tensor([NBl * page], dtype=torch.int32, device=dev)
    ql = rand(1, H, D)
    errl, sharel = assert_bf16("paged_decode one long sequence", paged_decode(ql, kpl, vpl, tabl, lensl),
                               paged_decode_ref(ql, kpl, vpl, tabl, lensl))
    rec["max_abs_err"] = max(rec["max_abs_err"], errl)
    sq, sk, sv, _ = _dense_sdpa_inputs(ql, kpl, vpl, tabl, lensl)
    boundl = _decode_bound(1, H, KVH, D, NBl * page, NBl)
    rec["large_one"] = {"shape": f"B1 H{H} KVH{KVH} D{D} page16 kv_len{NBl * page} shuffled bf16", "max_abs_err": errl,
                        "ms": graph_ms(lambda: paged_decode(ql, kpl, vpl, tabl, lensl), 200),
                        "plain_ms": graph_ms(lambda: paged_decode_ref(ql, kpl, vpl, tabl, lensl), 20),
                        "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(sq, sk, sv, enable_gqa=True), 200),
                        "bound_ms": boundl[0], "bound_by": boundl[1]}
    line("paged_decode", case=rec["large_one"]["shape"], max_abs_err=f"{errl:.3e}", tol=BF16_LIMIT,
         of_limit=f"{sharel:.3f}", kernel_ms=f"{rec['large_one']['ms']:.5f}",
         plain_ms=f"{rec['large_one']['plain_ms']:.5f}", library_ms=f"{rec['large_one']['library_ms']:.5f}",
         bound_ms=f"{boundl[0]:.5f}", bound_by=boundl[1])
    del kpl, vpl, sk, sv
    torch.cuda.empty_cache()

    # one 4096-token sequence at kimi-k2's head dim 112, bf16 and f32
    kpk, vpk = rand(NBl, page, 8, 112), rand(NBl, page, 8, 112)
    qk = rand(1, 64, 112)
    errk, sharek = assert_bf16("paged_decode kimi one long sequence", paged_decode(qk, kpk, vpk, tabl, lensl),
                               paged_decode_ref(qk, kpk, vpk, tabl, lensl))
    errk32, _ = assert_close("paged_decode kimi one long sequence f32",
                             paged_decode(qk.float(), kpk.float(), vpk.float(), tabl, lensl),
                             paged_decode_ref(qk.float(), kpk.float(), vpk.float(), tabl, lensl), F32_TOL)
    rec["max_abs_err"] = max(rec["max_abs_err"], errk)
    sq, sk, sv, _ = _dense_sdpa_inputs(qk, kpk, vpk, tabl, lensl)
    boundk = _decode_bound(1, 64, 8, 112, NBl * page, NBl)
    rec["large_one_kimi"] = {"shape": f"B1 H64 KVH8 D112 page16 kv_len{NBl * page} shuffled bf16", "max_abs_err": errk,
                             "ms": graph_ms(lambda: paged_decode(qk, kpk, vpk, tabl, lensl), 200),
                             "plain_ms": graph_ms(lambda: paged_decode_ref(qk, kpk, vpk, tabl, lensl), 20),
                             "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(sq, sk, sv, enable_gqa=True),
                                                    200),
                             "bound_ms": boundk[0], "bound_by": boundk[1]}
    line("paged_decode", case=rec["large_one_kimi"]["shape"], max_abs_err=f"{errk:.3e}", tol=BF16_LIMIT,
         of_limit=f"{sharek:.3f}", f32_err=f"{errk32:.3e}", f32_tol=F32_TOL,
         kernel_ms=f"{rec['large_one_kimi']['ms']:.5f}", plain_ms=f"{rec['large_one_kimi']['plain_ms']:.5f}",
         library_ms=f"{rec['large_one_kimi']['library_ms']:.5f}", bound_ms=f"{boundk[0]:.5f}", bound_by=boundk[1])
    del kpk, vpk, sk, sv
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


def phase_serve(seed, arch=ARCH, phase="serve", cfg=None):
    """Full-width ``arch`` (or ``cfg``, a cut of it) through ``launch.serve_e2e.main``: the staged
    workload with its prefills through the hook's captured step, then 8
    tokens through captured prefill and decode steps.  Gates: hits exact
    per stage; the wrappers' launch counts exact for the steps captured
    (each step's warm calls and its capture), and each step's replays
    those of the run.  The launches the replays ran are read from a device
    trace in phase steps (``steps_line``), from ``res["path_steps"]``."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.serve_e2e import main as serve_main
    from repro_torch.models import api
    from repro_torch.models.common import count_params, tree_leaves

    cfg = get_config(arch) if cfg is None else cfg
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed, "cuda")
    torch.cuda.synchronize()
    line(phase, arch=cfg.name, init_params_s=f"{time.perf_counter() - t0:.2f}", params=count_params(params),
         layers=cfg.n_layers, d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
         d_ff=cfg.d_ff, vocab=cfg.vocab_size,
         weights_gb=f"{sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9:.2f}")
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = serve_main(arch=arch, device="cuda", seed=seed, params=params, cfg=cfg)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    wall = time.perf_counter() - t0

    for st in res["stages"]:
        line(phase, stage=st["stage"], expect_hit=st["expect_hit"], hit=f"{st['hit']:.4f}",
             ttft_ms=f"{st['ttft_s'] * 1e3:.3f}", compute_ms=f"{st['compute_s'] * 1e3:.3f}",
             io_ms=f"{st['io_s'] * 1e3:.3f}")
        if abs(st["hit"] - st["expect_hit"]) > 1e-9:
            raise AssertionError(f"{phase}: stage {st['stage']} hit {st['hit']}, expected {st['expect_hit']} exactly")
    res["path_steps"] = path_steps(cfg, params, res["prompt"], res["greedy_steps"], res["hook"])
    captured, replays = serve_launch_gates(phase, cfg, res, counts)
    if not bool(torch.isfinite(res["decode_logits"]).all()):
        raise AssertionError(f"{phase}: non-finite decode logits")
    line(phase, wall_s=f"{wall:.2f}", prefills=res["prefills"], decoded=res["decoded"],
         decode_s=f"{res['decode_s']:.3f}", launches=json.dumps(counts).replace(" ", ""),
         steps_captured=json.dumps(captured).replace(" ", ""), replays=json.dumps(replays).replace(" ", ""),
         peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", store_bytes=res["store_bytes"])
    return cfg, params, res, counts


def serve_launch_gates(phase, cfg, res, counts):
    """A serve run's launch gates: the wrappers' ``counts`` exact for the
    steps captured (each step's warm calls and its capture), and each
    step's replays (``res["path_steps"]``) those the run made: every
    prefill of the hook, the decode's prefill and its steps.  Returns the
    steps captured and the replays."""
    from repro_torch.graphs import WARM_CALLS

    captured = {"prefill": len(res["hook"].steps) + 1, "decode": 1}
    want = expected_launches(cfg, (WARM_CALLS + 1) * captured["prefill"], (WARM_CALLS + 1) * captured["decode"])
    replays = {kind: sum(r for _, k, _, r, _ in res["path_steps"] if k == kind) for kind in ("prefill", "decode")}
    if counts != want:
        raise AssertionError(f"{phase}: launch counts {counts}, expected {want} ({captured} steps captured, "
                             f"each {WARM_CALLS} warm calls and one capture)")
    ran = {"prefill": res["hook"].calls + 1, "decode": res["decode_steps"]}
    if replays != ran:
        raise AssertionError(f"{phase}: replays {replays}, the run made {ran['prefill']} prefills and "
                             f"{ran['decode']} decode steps")
    return captured, replays


def path_steps(cfg, params, prompt, steps, hook=None, frames=None):
    """The captured steps a main path ran, read just after it: (label,
    kind, step, replays on the path, a call that replays the step once
    more on the path's inputs).  The hook's prefill steps (a serve run),
    then ``greedy_decode``'s prefill and decode (``steps``)."""
    import torch

    from repro_torch.launch.serve_e2e import prefill_inputs

    toks = torch.tensor(prompt, dtype=torch.int64, device="cuda")[None, :]
    inputs = prefill_inputs(cfg, toks, frames)
    out = []
    for n, st in sorted((hook.steps if hook is not None else {}).items()):
        hook_toks = {"tokens": torch.zeros((1, n), dtype=torch.int64, device="cuda")}
        out.append((f"hook_prefill_{n}", "prefill", st, st.replays,
                    lambda st=st, t=hook_toks: st(params, t)))

    def decode():
        steps.pos.fill_(len(prompt))  # within the held cache's slots
        steps.decode(params, toks[:, :1], steps.cache, steps.pos)

    out.append(("prefill", "prefill", steps.prefill, steps.prefill.replays,
                lambda: steps.prefill(params, inputs, steps.cache)))
    out.append(("decode", "decode", steps.decode, steps.decode.replays, decode))
    return out


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


def path_times(cfg, params, prompt, fed, frames=None):
    """Warm prefill ms of ``prompt`` and decode ms per token of ``fed``
    (teacher-forced), on the kernel path and on the plain path, both eager
    (host clock, synchronised), as printable strings.  An encdec model takes ``frames``;
    its encoder's time, a part of the prefill's, is printed beside it."""
    import torch

    from repro_torch.launch.serve_e2e import greedy_decode, prefill_inputs
    from repro_torch.models import api, encdec

    toks = torch.tensor(prompt, dtype=torch.int64, device="cuda")[None, :]
    inputs = prefill_inputs(cfg, toks, frames)
    timing = {}
    for label, plain in (("kernel", False), ("plain", True)):
        pfn = api.prefill_fn(cfg, plain)

        def prefill():
            with torch.inference_mode():
                pfn(params, inputs, api.init_cache(cfg, 1, len(prompt), "cuda"), 0)

        prefill()
        timing[f"{label}_prefill_ms"] = _host_ms(prefill)
        if frames is not None:
            def encode():
                with torch.inference_mode():
                    encdec.encode(params, cfg, frames, plain)

            timing[f"{label}_encode_ms"] = _host_ms(encode)
        total = _host_ms(lambda: greedy_decode(cfg, params, prompt, len(fed), "cuda", plain, fed, frames,
                                               graphs=False))
        timing[f"{label}_decode_ms_per_token"] = (total - timing[f"{label}_prefill_ms"]) / len(fed)
    return {k: f"{v:.3f}" for k, v in timing.items()}


def phase_decode_check(cfg, params, res, phase="decode-check", table="profile_prefill.txt"):
    """Feed the serve run's decode inputs again (teacher forcing) through the
    kernel path and through the plain attention versions; compare logits
    and argmax tokens.  Also times, warm, one 128-token prefill and the
    8-step decode on each path (host clock, synchronised).  Returns the
    launches the serve run's graph replays ran and the steps' timings
    (``steps_line``).

    An moe model's routing decides its result, as in ``phase_model``: the
    kernel path's top-k choices are recorded on the same steps run eagerly
    (a replay runs no Python to record), teacher-forced on the serve run's
    inputs; the plain path on its own routing is printed with the choices
    that differ, and the gates read the plain path run on the kernel
    path's routing."""
    import torch

    from repro_torch.launch.serve_e2e import greedy_decode

    prompt, n, fed = res["prompt"], res["decode_steps"], res["decode_inputs"]
    moe = cfg.family == "moe"
    if moe:
        routing = RoutingRecorder()
        with routing:
            greedy_decode(cfg, params, prompt, n, "cuda", inputs=fed, graphs=False)
    plain_routing = RoutingRecorder() if moe else contextlib.nullcontext()
    with plain_routing:
        plain_tokens, _, plain_logits = greedy_decode(cfg, params, prompt, n, "cuda",
                                                      plain_kernels=True, inputs=fed)
    if moe:
        plain_tokens, plain_logits = plain_on_kernel_routing(cfg, params, prompt, fed, res["decode_logits"],
                                                             routing, plain_routing, plain_logits, phase)
    err = max_err(res["decode_logits"], plain_logits)
    scale = float(plain_logits.abs().max())
    agree = sum(a == b for a, b in zip(plain_tokens, res["decoded"])) / len(res["decoded"])
    line(phase, kernel_tokens=res["decoded"], plain_tokens=plain_tokens, agreement=f"{agree:.3f}",
         logits_max_abs_err=f"{err:.4e}", max_abs_logit=f"{scale:.4f}",
         tol=f"{LOGIT_REL_TOL}*max|logit|={LOGIT_REL_TOL * scale:.4f}")
    if agree < MIN_TOKEN_AGREEMENT or err > LOGIT_REL_TOL * scale or not bool(torch.isfinite(plain_logits).all()):
        raise AssertionError(f"{phase}: the kernel path and the plain path disagree")

    toks = torch.tensor(prompt, dtype=torch.int64, device="cuda")[None, :]
    line(phase, **path_times(cfg, params, prompt, fed))
    profile_prefill(cfg, params, toks, phase=phase, table=table)
    return steps_line(cfg, params, prompt, res["decoded"], res["decode_logits"], res["greedy_steps"],
                      res["path_steps"])


CLUSTER_NODES, CLUSTER_REPLICATION = 3, 2  # examples/failover.py's cluster
CLUSTER_SHARED = 96  # the degraded requests: a corpus prompt's first 96 tokens, then fresh ones
CLUSTER_SCRAPE_S = 5.0  # a scrape with a dead member returns within this (examples/failover.py)


class HookTap:
    """Wraps the serve hook and keeps a copy of every block list it hands
    the engine, with the tokens and the reuse it was called with."""

    def __init__(self, hook):
        self.hook, self.outputs = hook, []

    def __call__(self, tokens, reused):
        blocks, seconds = self.hook(tokens, reused)
        self.outputs.append((list(tokens), reused, [b.copy() for b in blocks]))
        return blocks, seconds


def _blocks_read_back(cluster, outputs, block):
    """The hook calls whose blocks do not read back from ``cluster`` bit
    for bit (one get_many over all of them)."""
    got = cluster.get_many([(toks, len(toks)) for toks, _, _ in outputs])
    bad = []
    for i, ((toks, reused, want), have) in enumerate(zip(outputs, got)):
        have = have[reused // block:]
        if len(have) != len(want) or any(h.dtype != w.dtype or h.tobytes() != w.tobytes()
                                         for h, w in zip(have, want)):
            bad.append(i)
    return bad


def phase_cluster(cfg, params, serve_stages, seed=SEED):
    """Full-width ``cfg`` on phase serve's weights through
    ``launch.serve_e2e.main`` over a ClusterKVBlockStore of 3 node processes
    (``python -m repro_torch.cluster.node``: LSM, codec raw, 2 I/O threads,
    node 0 with its metrics endpoint) at R 2: phase serve's workload,
    captures and gates.  Every block the hook handed over in the warm-up
    reads back bit for bit; then the first replica of the first corpus
    prompt is SIGKILLed: every committed prefix probes as before, the
    blocks read back, a fresh engine with empty device and host tiers
    serves a corpus prompt's first 96 tokens and 32 fresh ones per
    request from the surviving replicas (hit exactly 0.75), and a scrape
    returns at once with the victim down; the victim respawns cold on its
    address, maintenance revives it and a scrape is clean; node 0's HTTP
    endpoint answers with the server's counters.  Launch counters reset
    just before the serve run and read after the degraded one; the
    replays of both are read from a device trace.  Returns the launches
    and the replayed launches."""
    import tempfile
    import urllib.request

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.cluster import ClusterKVBlockStore, spawn_local_node
    from repro_torch.launch.serve_e2e import BLOCK, main as serve_main, make_engine
    from repro_torch.runtime import RuntimeServices
    from repro_torch.workload.staged import Request

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_cluster_")

    def spawn(i, port=0):
        return spawn_local_node(os.path.join(work, f"node_{i}"), port=port, block_size=BLOCK, codec="raw",
                                io_threads=2, metrics_port=0 if i == 0 else None)

    nodes, cluster = [], None
    try:
        t0 = time.perf_counter()
        nodes = [spawn(i) for i in range(CLUSTER_NODES)]
        cluster = ClusterKVBlockStore([n.address for n in nodes], replication=CLUSTER_REPLICATION, io_threads=2,
                                      retries=1, timeout_s=20.0)
        line("cluster", nodes=len(nodes), replication=cluster.replication, backend="lsm", codec="raw",
             addresses=";".join(f"{h}:{p}" for h, p in (n.address for n in nodes)),
             metrics_port=nodes[0].metrics_port, spawn_s=f"{time.perf_counter() - t0:.2f}")

        taps = []
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = serve_main(arch=cfg.name, device="cuda", seed=seed, params=params, cfg=cfg, store=cluster,
                         tap=lambda hook: taps.append(HookTap(hook)) or taps[-1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tap, hook = taps[0], res["hook"]
        for st, ref in zip(res["stages"], serve_stages):
            line("cluster", stage=st["stage"], expect_hit=st["expect_hit"], hit=f"{st['hit']:.4f}",
                 ttft_ms=f"{st['ttft_s'] * 1e3:.3f}", io_ms=f"{st['io_s'] * 1e3:.3f}",
                 compute_ms=f"{st['compute_s'] * 1e3:.3f}", serve_ttft_ms=f"{ref['ttft_s'] * 1e3:.3f}",
                 serve_io_ms=f"{ref['io_s'] * 1e3:.3f}", serve_compute_ms=f"{ref['compute_s'] * 1e3:.3f}")
            if abs(st["hit"] - st["expect_hit"]) > 1e-9:
                raise AssertionError(f"cluster: stage {st['stage']} hit {st['hit']}, expected {st['expect_hit']} "
                                     "exactly")

        warm = tap.outputs[:len(res["corpus"])]
        if sorted(t for t, _, _ in warm) != sorted(res["corpus"]) or any(r for _, r, _ in warm):
            raise AssertionError("cluster: the hook's first calls were not the warm-up's corpus prompts")
        n_warm = sum(len(b) for _, _, b in warm)
        bad = _blocks_read_back(cluster, warm, BLOCK)
        if bad:
            raise AssertionError(f"cluster: warm-up prompts {bad} do not read back bit for bit")
        committed = [cluster.probe(t) for t, _, _ in tap.outputs]
        stats = cluster.stats
        rpc = cluster.registry.snapshot()["gauges"]
        line("cluster", wall_s=f"{wall:.2f}", prefills=res["prefills"], decoded=res["decoded"],
             warm_blocks=n_warm, warm_read_back="bit_for_bit", put_blocks=stats.put_blocks,
             payload_bytes_in=stats.payload_bytes_in, disk_bytes=cluster.disk_bytes,
             rpc_bytes_sent=int(rpc.get("repro_rpc_bytes_sent", 0)), rpcs=int(rpc.get("repro_rpc_rpcs", 0)))

        victim = cluster.replicas_for(res["corpus"][0])[0]
        nodes[victim].kill()
        after = [cluster.probe(t) for t, _, _ in tap.outputs]
        if after != committed:
            lost = [i for i, (a, b) in enumerate(zip(after, committed)) if a < b]
            raise AssertionError(f"cluster: committed prefixes {lost} probe shorter after node {victim}'s kill")
        bad = _blocks_read_back(cluster, warm, BLOCK)
        if bad:
            raise AssertionError(f"cluster: warm-up prompts {bad} do not read back bit for bit after the kill")

        rng = np.random.default_rng(seed + 1)
        fresh = [Request(10_000 + i, 3, p[:CLUSTER_SHARED] + rng.integers(0, 50_000, len(p) - CLUSTER_SHARED).tolist(),
                         CLUSTER_SHARED / len(p)) for i, p in enumerate(res["corpus"])]
        runtime = RuntimeServices(io_threads=4)
        eng = make_engine(cfg, hook, cluster, runtime)  # empty device and host tiers
        try:
            for r in fresh:
                eng.submit(r)
            recs = eng.run()
            eng.drain()
        finally:
            eng.close()
        counts = kernels.launch_counts()
        hits = [r.reused_tokens / r.prompt_len for r in recs]
        cs = cluster.cluster_stats
        line("cluster", what="degraded", victim=victim, down=cluster.down_nodes, requests=len(recs),
             hits=sorted(set(hits)), ttft_ms=f"{np.mean([r.ttft_s for r in recs]) * 1e3:.3f}",
             io_ms=f"{np.mean([r.io_s for r in recs]) * 1e3:.3f}",
             compute_ms=f"{np.mean([r.compute_s for r in recs]) * 1e3:.3f}",
             hit_tiers_d_h_d=f"{eng.h.stats.tokens_hit_device}/{eng.h.stats.tokens_hit_host}/"
                             f"{eng.h.stats.tokens_hit_disk}",
             failovers=cs.failovers, degraded_reads=cs.degraded_reads)
        if len(recs) != len(fresh) or any(h != CLUSTER_SHARED / len(p) for h, p in zip(hits, res["corpus"])):
            raise AssertionError(f"cluster: degraded hits {hits}, expected {CLUSTER_SHARED / PROMPT} each")
        if eng.h.stats.tokens_hit_disk != CLUSTER_SHARED * len(fresh):
            raise AssertionError(f"cluster: {eng.h.stats.tokens_hit_disk} tokens came from the cluster, expected "
                                 f"{CLUSTER_SHARED * len(fresh)}")

        t0 = time.perf_counter()
        scrape = cluster.scrape_cluster()
        scrape_s = time.perf_counter() - t0
        if (victim not in scrape["down"] or not scrape["nodes"][victim].get("unreachable")
                or scrape_s > CLUSTER_SCRAPE_S
                or any(scrape["nodes"][i].get("unreachable") for i in range(len(nodes)) if i != victim)):
            raise AssertionError(f"cluster: the degraded scrape took {scrape_s:.3f} s, down {scrape['down']}, "
                                 f"victim {victim}")

        host, port = nodes[victim].address
        nodes[victim].close()
        shutil.rmtree(nodes[victim].root, ignore_errors=True)  # a cold restart, as examples/failover.py's
        nodes[victim] = spawn(victim, port)
        revived = cluster.maintenance(0)["revived"]
        healed = cluster.scrape_cluster()
        if revived != [victim] or cluster.down_nodes or healed["down"] or any(
                nd.get("unreachable") for nd in healed["nodes"].values()):
            raise AssertionError(f"cluster: revived {revived}, down {cluster.down_nodes}, scrape down "
                                 f"{healed['down']}")
        with urllib.request.urlopen(f"http://127.0.0.1:{nodes[0].metrics_port}/metrics", timeout=10) as resp:
            text = resp.read().decode()
        if "repro_server_requests" not in text or "# TYPE repro_node_request_seconds histogram" not in text:
            raise AssertionError("cluster: node 0's metrics endpoint lacks the server's counters")
        g = healed["cluster"]["gauges"]
        line("cluster", what="scrape", degraded_scrape_ms=f"{scrape_s * 1e3:.3f}", revived=revived,
             failovers=int(g["repro_cluster_failovers"]), rpcs=int(g["repro_rpc_rpcs"]),
             rpc_bytes_sent=int(g["repro_rpc_bytes_sent"]), live=int(g["repro_cluster_live"]),
             repairs=int(g.get("repro_migration_repairs_completed", 0)),
             http_metrics_bytes=len(text), http_requests=next(
                 (ln.split()[-1] for ln in text.splitlines() if ln.startswith("repro_server_requests")), None))

        res["path_steps"] = path_steps(cfg, params, res["prompt"], res["greedy_steps"], hook)
        captured, replays = serve_launch_gates("cluster", cfg, res, counts)
        _, replayed, failed = path_replays(cfg, res["path_steps"])
        if failed:
            raise AssertionError("cluster: " + "; ".join(failed))
        line("cluster", launches=_nonzero(counts), steps_captured=json.dumps(captured).replace(" ", ""),
             replays=json.dumps(replays).replace(" ", ""), path_replayed_launches=_nonzero(replayed),
             phase_s=f"{time.perf_counter() - t_phase:.2f}")
        return counts, replayed
    finally:
        if cluster is not None:
            cluster.close()
        for n in nodes:
            n.close()
        shutil.rmtree(work, ignore_errors=True)


def profile_prefill(cfg, params, toks, phase: str = "profile", table: str = "profile_prefill.txt", frames=None):
    """torch.profiler over one warm kernel-path prefill (an encdec model's
    on ``frames``), as ``profile_call`` reports it."""
    import torch

    from repro_torch.launch.serve_e2e import prefill_inputs
    from repro_torch.models import api

    pfn = api.prefill_fn(cfg)
    inputs = prefill_inputs(cfg, toks, frames)

    def prefill():
        with torch.inference_mode():
            pfn(params, inputs, api.init_cache(cfg, 1, toks.shape[1], "cuda"), 0)

    prefill()
    profile_call(prefill, phase, table, f"one warm {toks.shape[1]}-token prefill, kernel path, under torch.profiler")


def profile_call(fn, phase: str, table: str, what: str, ops=()):
    """torch.profiler over one call of ``fn``: device busy time (sum of
    kernel times, one stream) against the synchronised wall time, and the
    kernels that take it.  The table is written to the file ``table`` in
    the output directory beside this script.  Returns (wall ms, busy ms,
    each kernel's launches in the trace, the device ms of the kernels each
    op of ``ops`` launched: aten names, as in the table)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from repro_torch.kernels import traced_launch_counts

    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    traced = traced_launch_counts((e.key, e.count) for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", table), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=30))
    op_ms = {op: sum(e.device_time_total for e in events if e.key == op) / 1e3 for op in ops}
    line(phase, what=what, wall_ms=f"{wall_ms:.3f}", device_busy_ms=f"{busy_ms:.3f}",
         idle_share=f"{max(0.0, 1 - busy_ms / wall_ms):.3f}",
         top=";".join(f"{e.key[:40]}:{e.self_device_time_total / 1e3:.3f}ms" for e in top),
         **{f"{op.replace('aten::', '')}_device_ms": f"{ms:.3f}" for op, ms in op_ms.items()})
    return wall_ms, busy_ms, traced, op_ms


def traced_launches(fn):
    """Each kernel's launches in a device trace (torch.profiler) of one
    call of ``fn``: what a replayed CUDA graph ran, which no wrapper
    counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import traced_launch_counts

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return traced_launch_counts((e.key, e.count) for e in prof.key_averages()
                                if e.device_type == torch.autograd.DeviceType.CUDA)


STEPS_LOGIT_REL_TOL = 0.01  # graph vs eager kernel path: the same kernels on the same inputs


def steps_line(cfg, params, prompt, graph_tokens, graph_logits, steps, path, frames=None, eager=None):
    """Phase ``steps`` for one family: the main path's captured greedy
    decode (``graph_tokens``, ``graph_logits``, run on the captured
    ``steps``) against the same steps run eagerly through the kernels
    (``eager``, run here when not given: a ``greedy_decode(...,
    graphs=False)`` result), gated on equal tokens and max |dlogit| <=
    STEPS_LOGIT_REL_TOL of max |logit|; then the main path's own captured
    prefill and decode timed against the same steps made eager (host
    clock, synchronised, median of 5; decode over a run of 8 steps), the
    graphs' device times (CUDA events), their capture's seconds and pool,
    one eager and one graph prefill under torch.profiler (idle share
    against the profiled wall and against the unprofiled host time).
    Last, one replay of every captured step the main path ran (``path``,
    from ``path_steps``) under torch.profiler: its launches per replay,
    gated exact and equal to what its capture recorded, times its replays
    on the main path.  Returns those, the main path's launches on the
    card, gated exact for the path's prefills and decode steps, and the
    timings above (their keys as printed)."""
    import torch

    from repro_torch.launch.serve_e2e import greedy_decode, make_greedy_steps, prefill_inputs

    n = len(graph_tokens)
    if eager is None:
        eager = greedy_decode(cfg, params, prompt, n, "cuda", frames=frames, graphs=False)
    eager_tokens, _, eager_logits = eager
    gap, scale = max_err(graph_logits, eager_logits), float(eager_logits.abs().max())
    failed = []
    if eager_tokens != graph_tokens or gap > STEPS_LOGIT_REL_TOL * scale:
        failed.append(f"graph tokens {graph_tokens} vs eager {eager_tokens}, logit gap {gap:.4e}")

    toks = torch.tensor(prompt, dtype=torch.int64, device="cuda")[None, :]
    inputs = prefill_inputs(cfg, toks, frames)
    tok = toks[:, :1]
    made = make_greedy_steps(cfg, params, len(prompt), n, "cuda", frames=frames, graphs=False)
    with torch.inference_mode():
        for st in (made, steps):
            st.pos.fill_(len(prompt))  # within the held caches' slots

    def run(fn, *args, times=1):
        def call():
            with torch.inference_mode():
                for _ in range(times):
                    fn(*args)
        return call

    e_prefill, g_prefill = run(made.prefill, params, inputs, made.cache), run(steps.prefill, params, inputs, steps.cache)
    e_decode = run(made.decode, params, tok, made.cache, made.pos, times=n)
    g_decode = run(steps.decode, params, tok, steps.cache, steps.pos, times=n)
    timing = {"eager_prefill_ms": _host_ms(e_prefill), "graph_prefill_ms": _host_ms(g_prefill),
              "eager_decode_ms_per_token": _host_ms(e_decode) / n,
              "graph_decode_ms_per_token": _host_ms(g_decode) / n}

    def device_ms(call):  # CUDA events around the replays: the graph's time on the card, median of 5
        times = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    timing["graph_prefill_device_ms"] = device_ms(g_prefill)
    timing["graph_decode_device_ms_per_token"] = device_ms(g_decode) / n
    name = cfg.name.split("-")[0]
    prof = {label: profile_call(fn, "steps", f"profile_steps_{name}_{label}.txt",
                                f"{cfg.name}: one warm {len(prompt)}-token prefill, {label}, under torch.profiler")
            for label, fn in (("eager", e_prefill), ("graph", g_prefill))}

    per_replay, replayed, path_failed = path_replays(cfg, path)
    failed += path_failed
    steps_p, steps_d = steps.prefill, steps.decode
    line("steps", arch=cfg.name, tokens_equal=eager_tokens == graph_tokens, logit_gap=f"{gap:.4e}",
         max_abs_logit=f"{scale:.4f}", tol=f"{STEPS_LOGIT_REL_TOL}*max|logit|={STEPS_LOGIT_REL_TOL * scale:.4f}",
         **{k: f"{v:.3f}" for k, v in timing.items()},
         prefill_capture_s=f"{steps_p.capture_s:.3f}", decode_capture_s=f"{steps_d.capture_s:.3f}",
         prefill_pool_mb=f"{steps_p.pool_bytes / 1e6:.1f}", decode_pool_mb=f"{steps_d.pool_bytes / 1e6:.1f}",
         eager_busy_ms=f"{prof['eager'][1]:.3f}", eager_idle_share=f"{max(0.0, 1 - prof['eager'][1] / prof['eager'][0]):.3f}",
         graph_busy_ms=f"{prof['graph'][1]:.3f}", graph_idle_share=f"{max(0.0, 1 - prof['graph'][1] / prof['graph'][0]):.3f}",
         # busy against the unprofiled host times above: the profiler's own
         # overhead stretches the wall of a 20 ms graph by ~10 ms
         eager_idle_share_unprofiled=f"{max(0.0, 1 - prof['eager'][1] / timing['eager_prefill_ms']):.3f}",
         graph_idle_share_unprofiled=f"{max(0.0, 1 - prof['graph'][1] / timing['graph_prefill_ms']):.3f}",
         prefill_launches=_nonzero(per_replay["prefill"]), decode_launches=_nonzero(per_replay["decode"]),
         traced_per_replay=json.dumps({k: {n_: v for n_, v in c.items() if v} for k, c in per_replay.items()})
         .replace(" ", ""),
         replays=json.dumps({label: r for label, _, _, r, _ in path}).replace(" ", ""),
         path_replayed_launches=_nonzero(replayed))
    del made
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"steps {cfg.name}: " + "; ".join(failed))
    return replayed, timing


def path_replays(cfg, path):
    """One replay of every captured step a main path ran (``path``, from
    ``path_steps``) under torch.profiler: its launches per replay, gated
    exact and equal to what its capture recorded, times its replays on
    the path.  Returns the launches per replay by label, the path's
    replayed launches (gated exact for its prefills and decode steps) and
    the gates that failed."""
    import torch

    per_replay, replayed, ran, failed = {}, dict.fromkeys(KERNELS, 0), {"prefill": 0, "decode": 0}, []

    def once(call):
        def replay():
            with torch.inference_mode():
                call()
        return replay

    for label, kind, step, replays, call in path:
        traced = traced_launches(once(call))
        want = expected_launches(cfg, 1, 0) if kind == "prefill" else expected_launches(cfg, 0, 1)
        if traced != want or traced != step.launches:
            failed.append(f"{label}: launches per replay {_nonzero(traced)} in the trace, captured "
                          f"{_nonzero(step.launches)}, want {_nonzero(want)}")
        per_replay[label] = traced
        ran[kind] += replays
        for k in replayed:
            replayed[k] += traced[k] * replays
    want_path = expected_launches(cfg, ran["prefill"], ran["decode"])
    if replayed != want_path:
        failed.append(f"the main path's replays ran {_nonzero(replayed)}, want {_nonzero(want_path)} "
                      f"({ran['prefill']} prefills, {ran['decode']} decode steps)")
    return per_replay, replayed, failed


def _nonzero(counts):
    return json.dumps({k: v for k, v in counts.items() if v}).replace(" ", "")


# ------------------------------------------------------- recurrent scans
def _scan_case(name, rec, out, ref, tol, **kv):
    """Hold (y, state) against the plain version's; print one line."""
    (err_y, share_y), (err_s, share_s) = (assert_close(f"{name} {what}", o, r, tol)
                                          for what, o, r in zip(("y", "state"), out, ref))
    rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), err_y, err_s)
    line(name, max_abs_err=f"{max(err_y, err_s):.3e}", y_err=f"{err_y:.3e}", state_err=f"{err_s:.3e}",
         tol=f"atol=rtol={tol}", of_limit=f"{max(share_y, share_s):.3f}", **kv)


def _chunks(S: int, C: int):
    """Steps in each chunk of an S-step scan (the last one ragged)."""
    return [min(C, S - c0) for c0 in range(0, S, C)]


def _wkv_bound(B, S, H, N, C, in_bytes):
    """r, k, v read once (in_bytes each), w, u, state in, y and state out
    in f32; the closed form's products per (b, h) and chunk of L steps:
    r_dec·S and the state update 4·L·N², A and A·v 2·L·(L-1)·N."""
    nbytes = 3 * in_bytes * B * S * H * N + 4 * (2 * B * S * H * N + H * N + 2 * B * H * N * N)
    flops = B * H * sum(4 * L * N * N + 2 * L * (L - 1) * N for L in _chunks(S, C))
    return bound_ms(nbytes, flops, TF32_FLOP_PER_S)


def _ssd_bound(B, S, H, P, N, C, in_bytes):
    """x, B, C read once (in_bytes each), a, dt, state in, y and state out
    in f32; per (b, h) and chunk of L steps: C·Bᵀ and W·x over the L(L+1)/2
    kept pairs, C·Sᵀ and the state update 2·L·P·N each."""
    nbytes = in_bytes * B * S * (H * P + 2 * N) + 4 * (2 * B * S * H + 2 * B * H * P * N + B * S * H * P)
    flops = B * H * sum(L * (L + 1) * (N + P) + 4 * L * P * N for L in _chunks(S, C))
    return bound_ms(nbytes, flops, TF32_FLOP_PER_S)


def phase_wkv():
    import torch

    from repro_torch.kernels.rwkv6 import wkv, wkv_chunked_plain, wkv_model, wkv_ref

    g = torch.Generator(device="cuda").manual_seed(2)

    def rand(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)

    def model_decay(*shape):  # exp(-exp(w0 + xw)), xw ~ N(0,1) as at full width
        return torch.exp(-torch.exp(rand(*shape)))

    rec = {}
    # (a) the rwkv6 path: one 128-token prompt, B1 H32 N64, bf16 r/k/v
    B, S, H, N, C = 1, 128, 32, 64, 16
    r, k, v = (rand(B, S, H, N, dtype=torch.bfloat16) for _ in range(3))
    w, u, s0 = model_decay(B, S, H, N), rand(H, N, scale=0.3), rand(B, H, N, N, scale=0.5)
    clamped = float((torch.log(w) < -80.0 / C).float().mean())
    _scan_case("wkv", rec, wkv_model(r, k, v, w, u, s0, chunk=C), wkv_chunked_plain(r, k, v, w, u, s0, C), WKV_TOL,
               case=f"path B{B} S{S} H{H} N{N} chunk{C} model-layout bf16-rkv", clamped_share=f"{clamped:.4f}")
    if clamped <= 0.0:
        raise AssertionError("wkv: the model's decay should hit the chunk-16 clamp in some channels")
    rec["ms"] = graph_ms(lambda: wkv_model(r, k, v, w, u, s0, chunk=C), 100)
    rec["plain_ms"] = graph_ms(lambda: wkv_chunked_plain(r, k, v, w, u, s0, C), 10)
    rec["bound_ms"], rec["bound_by"] = _wkv_bound(B, S, H, N, C, 2)
    line("wkv", case="path timing", kernel_ms=f"{rec['ms']:.5f}", plain_ms=f"{rec['plain_ms']:.5f}",
         library_ms="null", bound_ms=f"{rec['bound_ms']:.5f}", bound_by=rec["bound_by"],
         of_bound=f"{rec['ms'] / rec['bound_ms']:.1f}x")

    # (b) ragged S with a carried state, f32 r/k/v, N 32
    B2, S2, H2, N2 = 2, 77, 4, 32
    ins = [rand(B2, S2, H2, N2) for _ in range(3)] + [model_decay(B2, S2, H2, N2), rand(H2, N2, scale=0.3),
                                                      rand(B2, H2, N2, N2, scale=0.5)]
    _scan_case("wkv", rec, wkv_model(*ins, chunk=C), wkv_chunked_plain(*ins, C), WKV_TOL,
               case=f"ragged B{B2} S{S2} H{H2} N{N2} chunk{C} carried-state f32")

    # (c) the long-context shape (LONG_CONTEXT_OK), S 4096
    SL = 4096
    rL, kL, vL = (rand(B, SL, H, N, dtype=torch.bfloat16) for _ in range(3))
    wL = model_decay(B, SL, H, N)
    errL = {}
    _scan_case("wkv", errL, wkv_model(rL, kL, vL, wL, u, s0, chunk=C), wkv_chunked_plain(rL, kL, vL, wL, u, s0, C),
               WKV_TOL, case=f"long B{B} S{SL} H{H} N{N} chunk{C} bf16-rkv")
    large = {"shape": f"B{B} S{SL} H{H} N{N} chunk{C} bf16 r/k/v", "max_abs_err": errL["max_abs_err"]}
    large["ms"] = graph_ms(lambda: wkv_model(rL, kL, vL, wL, u, s0, chunk=C), 10, reps=3)
    large["plain_ms"] = graph_ms(lambda: wkv_chunked_plain(rL, kL, vL, wL, u, s0, C), 1, reps=3)
    large["bound_ms"], large["bound_by"] = _wkv_bound(B, SL, H, N, C, 2)
    large["library_ms"] = None
    rec["large"] = large
    line("wkv", case="long timing", kernel_ms=f"{large['ms']:.4f}", plain_ms=f"{large['plain_ms']:.4f}",
         library_ms="null", bound_ms=f"{large['bound_ms']:.4f}", bound_by=large["bound_by"],
         of_bound=f"{large['ms'] / large['bound_ms']:.1f}x")
    del rL, kL, vL, wL

    # (d) the reference op's (B,H,S,N) layout at chunk 32, read through strides
    opins = [rand(2, H2, 100, 64) for _ in range(3)] + [model_decay(2, H2, 100, 64), rand(H2, 64, scale=0.3),
                                                        rand(2, H2, 64, 64, scale=0.5)]
    y_plain, s_plain = wkv_chunked_plain(*(t.transpose(1, 2) for t in opins[:4]), *opins[4:], 32)
    _scan_case("wkv", rec, wkv(*opins, chunk=32), (y_plain.transpose(1, 2), s_plain), WKV_TOL,
               case=f"op B2 H{H2} S100 N64 chunk32 (B,H,S,N) f32")
    # against the sequential oracle where w stays in (0.45, 0.95): the clamp is idle
    refins = list(opins)
    refins[3] = 0.45 + 0.5 * torch.sigmoid(rand(2, H2, 100, 64))
    _scan_case("wkv", {}, wkv(*refins, chunk=32), wkv_ref(*refins), WKV_TOL,
               case="op vs sequential oracle, w in (0.45, 0.95)")
    torch.cuda.empty_cache()
    return rec


def phase_ssd():
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.mamba2 import ssd, ssd_chunked, ssd_chunked_plain, ssd_ref

    g = torch.Generator(device="cuda").manual_seed(3)

    def inputs(B, S, H, P, N, dtype):
        def rand(*shape, scale=1.0):
            return torch.randn(shape, generator=g, device="cuda") * scale

        x, Bm, Cm = rand(B, S, H, P).to(dtype), rand(B, S, N).to(dtype), rand(B, S, N).to(dtype)
        dt = F.softplus(rand(B, S, H))
        a = torch.exp(-dt * torch.exp(rand(H, scale=0.3)))
        return [x, Bm, Cm, a, dt, rand(B, H, P, N, scale=0.5)]

    rec = {}
    # the zamba2 path: one 128-token prompt, B1 H64 P64 N64, bf16 x/B/C, chunk 256
    B, S, H, P, N, C = 1, 128, 64, 64, 64, 256
    ins = inputs(B, S, H, P, N, torch.bfloat16)
    _scan_case("ssd", rec, ssd_chunked(*ins, chunk=C), ssd_chunked_plain(*ins, C), SSD_TOL,
               case=f"path B{B} S{S} H{H} P{P} N{N} chunk{C} bf16-xBC")
    rec["ms"] = graph_ms(lambda: ssd_chunked(*ins, chunk=C), 100)
    rec["plain_ms"] = graph_ms(lambda: ssd_chunked_plain(*ins, C), 5)
    rec["bound_ms"], rec["bound_by"] = _ssd_bound(B, S, H, P, N, C, 2)
    line("ssd", case="path timing", kernel_ms=f"{rec['ms']:.5f}", plain_ms=f"{rec['plain_ms']:.5f}",
         library_ms="null", bound_ms=f"{rec['bound_ms']:.5f}", bound_by=rec["bound_by"],
         of_bound=f"{rec['ms'] / rec['bound_ms']:.1f}x")
    _scan_case("ssd", {}, ssd_chunked(*ins, chunk=C), ssd_ref(*ins), SSD_TOL,
               case="path vs sequential oracle")

    # ragged S over two chunks with a carried state, f32, P 32 N 16
    rg = inputs(2, 333, 3, 32, 16, torch.float32)
    _scan_case("ssd", rec, ssd_chunked(*rg, chunk=C), ssd_chunked_plain(*rg, C), SSD_TOL,
               case=f"ragged B2 S333 H3 P32 N16 chunk{C} carried-state f32")

    # S 4096 (LONG_CONTEXT_OK) at the model's chunk
    SL = 4096
    lg = inputs(B, SL, H, P, N, torch.bfloat16)
    errL = {}
    _scan_case("ssd", errL, ssd_chunked(*lg, chunk=C), ssd_chunked_plain(*lg, C), SSD_TOL,
               case=f"long B{B} S{SL} H{H} P{P} N{N} chunk{C} bf16-xBC")
    large = {"shape": f"B{B} S{SL} H{H} P{P} N{N} chunk{C} bf16 x/B/C", "max_abs_err": errL["max_abs_err"]}
    large["ms"] = graph_ms(lambda: ssd_chunked(*lg, chunk=C), 5, reps=3)
    large["plain_ms"] = graph_ms(lambda: ssd_chunked_plain(*lg, C), 1, reps=3)
    large["bound_ms"], large["bound_by"] = _ssd_bound(B, SL, H, P, N, C, 2)
    large["library_ms"] = None
    rec["large"] = large
    line("ssd", case="long timing", kernel_ms=f"{large['ms']:.4f}", plain_ms=f"{large['plain_ms']:.4f}",
         library_ms="null", bound_ms=f"{large['bound_ms']:.4f}", bound_by=large["bound_by"],
         of_bound=f"{large['ms'] / large['bound_ms']:.1f}x")
    del lg

    # the reference op at chunk 64 (shrunk to S when S divides it)
    op = inputs(2, 200, 4, 64, 64, torch.float32)
    _scan_case("ssd", rec, ssd(*op, chunk=64), ssd_chunked_plain(*op, 64), SSD_TOL,
               case="op B2 S200 H4 P64 N64 chunk64 f32")
    torch.cuda.empty_cache()
    return rec


# ------------------------------------- cells first served in full on the card
# (phase, arch, layers served: None for every layer).  kimi-k2 at full width
# and 1 of 61 layers: one layer with all 384 experts is 33.8 GB, so a second
# would leave no room for a 128-token prefill's 5.64 GB dispatch buffer.
FULL_CELLS = (("qwen2.5-32b", "qwen2.5-32b", None), ("chameleon-34b", "chameleon-34b", None),
              ("kimi-k2", "kimi-k2-1t-a32b", 1))
# device memory a cell may find in use when it starts (allocated and
# reserved): the earlier phases leave no weights, graph, hook or step alive
MEM_BEFORE_CELL_GB = 1.0


def _weight_bytes(params, expert_share=None) -> int:
    """Bytes of every weight; with ``expert_share`` (k / E), what one
    decoded token reads: that share of the expert weights and one row of
    the embedding."""
    total = 0
    for name, t in _named_leaves(params):
        nbytes = t.numel() * t.element_size()
        if expert_share is not None and name == "embed":
            nbytes = t.shape[-1] * t.element_size()
        elif expert_share is not None and ".moe.w_" in f".{name}":
            nbytes *= expert_share
        total += nbytes
    return int(total)


def moe_dispatch(cfg, params, prompt, phase: str):
    """One eager kernel-path prefill of ``prompt`` with its routing recorded,
    then under torch.profiler: each layer's dropless dispatch buffer (1, E,
    C, D) in bf16, C = ``moe_capacity`` (S·k), the share of its rows that
    hold no routed token (from the recorded top-k choices), and the expert
    products' device ms (the aten::bmm rows of the profile table)."""
    import torch

    from repro_torch.models import api
    from repro_torch.models.layers import moe_capacity

    toks = torch.tensor(prompt, dtype=torch.int64, device="cuda")[None, :]
    S, E, D = toks.shape[1], cfg.n_experts, cfg.d_model
    C = moe_capacity(cfg, S, dropless=True)
    pfn = api.prefill_fn(cfg)

    def prefill():
        with torch.inference_mode():
            pfn(params, {"tokens": toks}, api.init_cache(cfg, 1, S, "cuda"), 0)

    routing = RoutingRecorder()
    with routing:
        prefill()
    routed = sum(int(torch.bincount(ids.flatten(), minlength=E).clamp(max=C).sum()) for ids in routing.calls)
    rows = len(routing.calls) * E * C
    wall, busy, _, op_ms = profile_call(prefill, phase, f"profile_prefill_{phase}_dispatch.txt",
                                        f"one warm {S}-token prefill, kernel path, under torch.profiler",
                                        ops=("aten::bmm",))
    line(phase, what=f"dropless dispatch of one {S}-token prefill", capacity=C, buffer=f"1x{E}x{C}x{D}_bf16",
         buffer_bytes=E * C * D * 2, buffers=len(routing.calls), routed_rows=routed, rows=rows,
         zero_row_share=f"{1 - routed / rows:.5f}", expert_products_device_ms=f"{op_ms['aten::bmm']:.3f}",
         device_busy_ms=f"{busy:.3f}", expert_share_of_busy=f"{op_ms['aten::bmm'] / busy:.3f}")


def phase_full_cell(phase: str, arch: str, n_layers=None):
    """``arch`` at full width (``n_layers`` of its layers when given, else
    all) through phase serve's path and gates and phase decode-check's
    (an moe model's on the kernel path's routing), after a check that
    the card starts near empty.  Prints the decode ms a token against the
    bound of reading every weight once (and, for an moe model, the weights
    a token's top-k experts need) and the dispatch of one prefill; the
    peak memory of the phase.  Returns the cell's config, peak bytes,
    launch counts, replayed launches and step timings, and frees it all."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import HBM_BW

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    alloc, reserved = torch.cuda.memory_allocated() / 1e9, torch.cuda.memory_reserved() / 1e9
    total = torch.cuda.get_device_properties(0).total_memory
    full = get_config(arch)
    cfg = full if n_layers is None else dataclasses.replace(full, n_layers=n_layers)
    line(phase, before_allocated_gb=f"{alloc:.3f}", before_reserved_gb=f"{reserved:.3f}",
         limit_gb=MEM_BEFORE_CELL_GB, total_memory_gb=f"{total / 1e9:.2f}",
         reduced="none" if n_layers is None else f"n_layers_{full.n_layers}->{n_layers}", head=cfg.d_head,
         **({"experts": cfg.n_experts, "top_k": cfg.experts_per_token, "moe_d_ff": cfg.moe_d_ff}
            if cfg.family == "moe" else {}))
    if max(alloc, reserved) > MEM_BEFORE_CELL_GB:
        raise AssertionError(f"{phase}: {alloc:.3f} GB allocated, {reserved:.3f} GB reserved before the weights")
    cfg, params, res, counts = phase_serve(SEED, arch, phase=phase, cfg=cfg)
    replayed, timing = phase_decode_check(cfg, params, res, phase=f"{phase}-check",
                                          table=f"profile_prefill_{phase}.txt")
    decode_ms = timing["graph_decode_device_ms_per_token"]
    bounds = {"all_weights": _weight_bytes(params)}
    if cfg.family == "moe":
        bounds["active_weights"] = _weight_bytes(params, expert_share=cfg.experts_per_token / cfg.n_experts)
        moe_dispatch(cfg, params, res["prompt"], phase)
    line(phase, what="graph decode a token against reading its weights once at HBM_BW",
         graph_decode_device_ms_per_token=f"{decode_ms:.3f}",
         graph_prefill_device_ms=f"{timing['graph_prefill_device_ms']:.3f}",
         **{f"{k}_gb": f"{v / 1e9:.3f}" for k, v in bounds.items()},
         **{f"{k}_bound_ms": f"{v / HBM_BW * 1e3:.3f}" for k, v in bounds.items()},
         **{f"over_{k}_bound": f"{decode_ms / (v / HBM_BW * 1e3):.2f}x" for k, v in bounds.items()})
    peak = torch.cuda.max_memory_allocated()
    line(phase, peak_mem_gb=f"{peak / 1e9:.2f}", peak_reserved_gb=f"{torch.cuda.max_memory_reserved() / 1e9:.2f}",
         total_memory_gb=f"{total / 1e9:.2f}", seconds=f"{time.perf_counter() - t0:.1f}")
    out = {"phase": phase, "cfg": cfg, "peak_bytes": peak, "counts": counts, "replayed": replayed,
           "timing": timing}
    del params, res
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------- full-width models
MODELS = {"rwkv6": "rwkv6-1.6b", "zamba2": "zamba2-1.2b", "olmoe": "olmoe-1b-7b", "minicpm3": "minicpm3-4b",
          "whisper": "whisper-small"}
PROMPT, DECODE, HALF = 128, 8, 64
KERNELS = tuple(TRACE_SYMBOLS)  # every counted kernel: the six Pallas kernels' and the fused AdamW's three


def expected_launches(cfg, prefills: int, tokens: int):
    """Kernel launches of ``prefills`` prefills and ``tokens`` decode steps."""
    from repro_torch.models.transformer import n_attn_sites

    want = dict.fromkeys(KERNELS, 0)
    L = cfg.n_layers
    if cfg.family == "rwkv6":
        want["wkv"] = L * prefills
    elif cfg.family == "encdec":  # encoder + decoder self + cross; decode: self + cross
        want.update(flash=(cfg.n_enc_layers + 2 * L) * prefills, paged_decode=2 * L * tokens)
    elif cfg.family == "hybrid":
        sites = n_attn_sites(cfg)
        want.update(flash=sites * prefills, paged_decode=sites * tokens, ssd=L * prefills)
    elif cfg.attention == "mla":  # decode is the absorbed plain-torch path
        want["flash"] = L * prefills
    else:
        want.update(flash=L * prefills, paged_decode=L * tokens)
    return want


def _widths(cfg):
    from repro_torch.models.transformer import n_attn_sites

    if cfg.family == "rwkv6":
        return dict(heads=cfg.n_heads, head=cfg.d_head, d_ff=cfg.d_ff)
    if cfg.family == "encdec":
        return dict(enc_layers=cfg.n_enc_layers, enc_frames=cfg.enc_frames, heads=cfg.n_heads,
                    kv_heads=cfg.n_kv_heads, head=cfg.d_head, d_ff=cfg.d_ff)
    if cfg.family == "hybrid":
        return dict(ssm_heads=cfg.ssm_heads, ssm_state=cfg.ssm_state, d_inner=cfg.expand * cfg.d_model,
                    attn_sites=n_attn_sites(cfg), heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff)
    if cfg.attention == "mla":
        return dict(heads=cfg.n_heads, q_lora=cfg.q_lora_rank, kv_lora=cfg.kv_lora_rank, qk_nope=cfg.qk_nope_dim,
                    qk_rope=cfg.qk_rope_dim, v_head=cfg.v_head_dim, d_ff=cfg.d_ff)
    return dict(heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, head=cfg.d_head, experts=cfg.n_experts,
                top_k=cfg.experts_per_token, moe_d_ff=cfg.moe_d_ff)


def f32_tree(tree):
    return {k: f32_tree(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.float()


def _cache(cfg, max_seq: int, f32: bool):
    """A B = 1 cache on the card; ``f32`` casts every leaf to f32."""
    from repro_torch.models import api

    cache = api.init_cache(cfg, 1, max_seq, "cuda")
    return {k: v.float() for k, v in cache.items()} if f32 else cache


def teacher_forced(cfg, params, prompt, fed, plain: bool, frames=None):
    """Prefill ``prompt`` (an encdec model's on ``frames``), then decode
    feeding ``fed`` one token at a time, with f32 caches (for f32 weights);
    per-step logits (n, V) in f32."""
    import torch

    from repro_torch.launch.serve_e2e import prefill_inputs
    from repro_torch.models import api

    prefill, decode = api.prefill_fn(cfg, plain), api.decode_fn(cfg, plain)
    with torch.inference_mode():
        cache = _cache(cfg, len(prompt) + len(fed), True)
        toks = torch.tensor(prompt, device="cuda")[None, :]
        _, cache = prefill(params, prefill_inputs(cfg, toks, frames), cache, 0)
        steps = []
        for i, tok in enumerate(fed):
            logits, cache = decode(params, torch.tensor([[tok]], device="cuda"), cache, len(prompt) + i)
            steps.append(logits[0, -1].float())
    return torch.stack(steps)


def chained_prefill(cfg, params, toks, plain: bool, f32: bool, frames=None):
    """Logits of the last PROMPT - HALF tokens from one prefill of the whole
    prompt, and from a prefill of HALF tokens followed by one of the rest at
    pos HALF, the states carried in the cache (an encdec model's prefills
    all on the same ``frames``)."""
    import torch

    from repro_torch.launch.serve_e2e import prefill_inputs
    from repro_torch.models import api

    prefill = api.prefill_fn(cfg, plain)
    with torch.inference_mode():
        full, _ = prefill(params, prefill_inputs(cfg, toks, frames), _cache(cfg, PROMPT, f32), 0)
        cache = _cache(cfg, PROMPT, f32)
        _, cache = prefill(params, prefill_inputs(cfg, toks[:, :HALF], frames), cache, 0)
        tail, _ = prefill(params, prefill_inputs(cfg, toks[:, HALF:], frames), cache, HALF)
    return full[:, HALF:].float(), tail.float()


class RoutingRecorder:
    """While active, records the top-k expert ids of every ``moe_layer``
    call of the port's forward (the probabilities it returns, sorted as
    ``layers.moe_route`` sorts them).  Reads what the layer computes and
    changes nothing."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import torch

        from repro_torch.models import transformer

        self._real = real = transformer.moe_layer

        def spy(p, cfg, x, dropless=False):
            out, probs = real(p, cfg, x, dropless)
            ids = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :cfg.experts_per_token]
            self.calls.append(ids)
            return out, probs

        transformer.moe_layer = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer

        transformer.moe_layer = self._real


class RoutingReplay:
    """While active, each ``moe_layer`` call routes to the expert ids
    recorded at the same call of another run (``calls``, in call order),
    with gate weights from this run's own probabilities at those ids.  The
    plain path then takes the kernel path's routing, so comparing the two
    holds the kernels, not near-tie routing choices that a one-ulp
    difference upstream flips."""

    def __init__(self, calls):
        self.calls = calls

    def __enter__(self):
        import torch

        from repro_torch.models import layers

        self._real = real = layers.moe_route
        recorded = iter(self.calls)

        def pinned(p, cfg, x):
            probs, _, _ = real(p, cfg, x)
            ids = next(recorded).view(*x.shape[:-1], cfg.experts_per_token)
            w = torch.gather(probs, -1, ids)
            return probs, w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), ids

        layers.moe_route = pinned
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers

        layers.moe_route = self._real


def plain_on_kernel_routing(cfg, params, prompt, fed, logits, routing, plain_routing, plain_logits, phase):
    """The plain path teacher-forced on ``fed`` again, each moe call on the
    kernel path's top-k choices (``routing``, a ``RoutingRecorder`` over the
    kernel path's run on the same inputs): its (tokens, logits).  Prints
    how many choices the plain path's own run (``plain_routing``, giving
    ``plain_logits``) made otherwise, and its logit error against the
    kernel path's ``logits``."""
    from repro_torch.launch.serve_e2e import greedy_decode

    diff, total = routing_differences(routing.calls, plain_routing.calls, cfg.n_experts)
    err, scale = max_err(logits, plain_logits), float(plain_logits.abs().max())
    line(phase, check="top-k routing, kernel path vs plain path, bf16", routing_choices_differing=diff,
         routing_choices=total, moe_calls=len(routing.calls), logits_max_abs_err_own_routing=f"{err:.4e}",
         of_max_abs_logit=f"{err / scale:.4f}")
    with RoutingReplay(routing.calls):
        tokens, _, replayed = greedy_decode(cfg, params, prompt, len(fed), "cuda", plain_kernels=True, inputs=fed)
    return tokens, replayed


def routing_differences(a, b, n_experts: int):
    """(expert choices in ``a`` not made in ``b``, all choices): the two
    recordings cover the same calls on the same tokens."""
    import torch

    if len(a) != len(b):
        raise AssertionError(f"routing recordings of {len(a)} and {len(b)} moe calls")
    diff = total = 0
    for x, y in zip(a, b):
        ox = torch.zeros(x.shape[0], n_experts, device=x.device).scatter_(1, x, 1.0)
        oy = torch.zeros(y.shape[0], n_experts, device=y.device).scatter_(1, y, 1.0)
        diff += int((ox - oy).clamp(min=0).sum())
        total += x.numel()
    return diff, total


def latent_slab(cfg, params, toks):
    """minicpm3-4b's latent cache of the first 16 prompt tokens after a
    kernel-path prefill, as a (16, L·(kv_lora + rope)) bf16 slab: c ‖ kr
    per layer, side by side."""
    import torch

    from repro_torch.models import api

    with torch.inference_mode():
        cache = api.init_cache(cfg, 1, toks.shape[1], "cuda")
        api.prefill_fn(cfg)(params, {"tokens": toks}, cache, 0)
        slab = torch.cat([cache["c"][:, 0, :16], cache["kr"][:, 0, :16]], dim=-1)  # (L, 16, 288)
    return slab.permute(1, 0, 2).reshape(16, -1).contiguous()


def phase_model(phase: str, seed: int, capture=None):
    """A full-width model from ``seed``: greedy decode through the kernels,
    held against the plain versions (in bf16 and on an f32 copy of the
    weights); chaining of prefills; timings; a profile.  Returns the
    wrappers' launch counts of the kernel-path run (captures included),
    the launches its graph replays ran on the card (phase steps), and what
    ``capture(cfg, params, toks)`` returns while the weights are on the
    card."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.graphs import WARM_CALLS
    from repro_torch.launch.serve_e2e import greedy_decode, make_greedy_steps
    from repro_torch.models import api
    from repro_torch.models.common import count_params, tree_leaves

    cfg = get_config(MODELS[phase])
    moe = cfg.family == "moe"
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed, "cuda")
    torch.cuda.synchronize()
    line(phase, arch=cfg.name, init_params_s=f"{time.perf_counter() - t0:.2f}", params=count_params(params),
         weights_gb=f"{sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9:.2f}",
         layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab_size, **_widths(cfg))
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size, PROMPT).tolist()
    frames = None  # an encdec model's stub frontend output, (1, enc_frames, d_model) bf16
    if cfg.family == "encdec":
        frames = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (1, cfg.enc_frames, cfg.d_model), dtype=np.float32)).to("cuda", torch.bfloat16)

    kernels.reset_launch_counts()
    steps = make_greedy_steps(cfg, params, PROMPT, DECODE, "cuda", frames=frames)  # captured
    tokens, fed, logits = greedy_decode(cfg, params, prompt, DECODE, "cuda", frames=frames, steps=steps)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    path = path_steps(cfg, params, prompt, steps, frames=frames)
    # the same steps eagerly through the kernels, for phase steps; an moe
    # model's routing is recorded here (a replay runs no Python to record)
    routing = RoutingRecorder() if moe else contextlib.nullcontext()
    with routing:
        eager = greedy_decode(cfg, params, prompt, DECODE, "cuda", frames=frames, graphs=False)
    # a replay runs no wrapper: the counts are the two captured steps' warm
    # calls and captures; what the replays ran is read from a device trace
    # in phase steps
    want = expected_launches(cfg, WARM_CALLS + 1, WARM_CALLS + 1)
    replays = {label: r for label, _, _, r, _ in path}
    line(phase, kernel_tokens=tokens, launches=json.dumps(counts).replace(" ", ""),
         replays=json.dumps(replays).replace(" ", ""))
    if counts != want:
        raise AssertionError(f"{phase}: launch counts {counts}, expected {want} (a prefill and a decode step "
                             f"captured, each {WARM_CALLS} warm calls and one capture)")
    if replays != {"prefill": 1, "decode": DECODE}:
        raise AssertionError(f"{phase}: replays {replays}, expected 1 prefill and {DECODE} decode steps")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{phase}: non-finite decode logits")

    # The plain versions on the same inputs, teacher-forced.  In bf16, the
    # models' own dtype, the logits are gated at LOGIT_REL_TOL; token
    # agreement and chaining are printed and not gated: at full width with
    # random weights a bf16 rounding that differs anywhere (a kernel's f32
    # sum order, or cuBLAS tiling another M) grows with depth, in the plain
    # path against itself as much as against the kernels, and flips
    # near-tie argmaxes among 32k-151k random logits (PERF.md, Findings).
    # Agreement and chaining are gated on an f32 copy of the same weights
    # through the same kernels, where rounding stays too small to grow.
    plain_routing = RoutingRecorder() if moe else contextlib.nullcontext()
    with plain_routing:
        plain_tokens, _, plain_logits = greedy_decode(cfg, params, prompt, DECODE, "cuda", plain_kernels=True,
                                                      inputs=fed, frames=frames)
    agree = sum(a == b for a, b in zip(plain_tokens, tokens)) / DECODE
    err, scale = max_err(logits, plain_logits), float(plain_logits.abs().max())
    what = "teacher-forced plain path, bf16 (agreement and chaining not gated)"
    if moe:
        # routing decides the result: the gate reads the plain path run
        # on the kernel path's routing
        _, plain_logits = plain_on_kernel_routing(cfg, params, prompt, fed, logits, routing, plain_routing,
                                                  plain_logits, phase)
        err, scale = max_err(logits, plain_logits), float(plain_logits.abs().max())
        what = "teacher-forced plain path on the kernel path's routing, bf16 (agreement and chaining not gated)"
    toks = torch.tensor(prompt, dtype=torch.int64, device="cuda")[None, :]
    spread = {label: max_err(*chained_prefill(cfg, params, toks, plain, f32=False, frames=frames))
              for label, plain in (("kernel", False), ("plain", True))}
    line(phase, check=what, plain_tokens=plain_tokens, agreement=f"{agree:.3f}", logits_max_abs_err=f"{err:.4e}",
         max_abs_logit=f"{scale:.4f}", tol=f"{LOGIT_REL_TOL}*max|logit|={LOGIT_REL_TOL * scale:.4f}",
         chaining_err_kernel_path=f"{spread['kernel']:.4e}", chaining_err_plain_path=f"{spread['plain']:.4e}")
    # every gate below is read before the phase fails, so one run shows them all
    failed = []
    if err > LOGIT_REL_TOL * scale or not bool(torch.isfinite(plain_logits).all()):
        failed.append("the kernel path and the plain path disagree in bf16")

    params32 = f32_tree(params)
    frames32 = None if frames is None else frames.float()
    k32 = teacher_forced(cfg, params32, prompt, fed, plain=False, frames=frames32)
    p32 = teacher_forced(cfg, params32, prompt, fed, plain=True, frames=frames32)
    err, scale = max_err(k32, p32), float(p32.abs().max())
    agree = float((k32.argmax(-1) == p32.argmax(-1)).float().mean())
    line(phase, check="teacher-forced plain path, f32 weights and caches", agreement=f"{agree:.3f}",
         logits_max_abs_err=f"{err:.4e}", max_abs_logit=f"{scale:.4f}",
         tol=f"{F32_LOGIT_REL_TOL}*max|logit|={F32_LOGIT_REL_TOL * scale:.4f}")
    if agree < MIN_TOKEN_AGREEMENT or err > F32_LOGIT_REL_TOL * scale or not bool(torch.isfinite(p32).all()):
        failed.append("the kernel path and the plain path disagree in f32")
    full, tail = chained_prefill(cfg, params32, toks, plain=False, f32=True, frames=frames32)
    cerr, cscale = max_err(tail, full), float(full.abs().max())
    line(phase, check=f"chained prefill {HALF}+{PROMPT - HALF} vs {PROMPT}, f32, kernel path",
         logits_max_abs_err=f"{cerr:.4e}", max_abs_logit=f"{cscale:.4f}",
         tol=f"{F32_LOGIT_REL_TOL}*max|logit|={F32_LOGIT_REL_TOL * cscale:.4f}")
    if cerr > F32_LOGIT_REL_TOL * cscale or not bool(torch.isfinite(tail).all()):
        failed.append("chained prefill disagrees with the single-shot prefill")
    if failed:
        raise AssertionError(f"{phase}: " + "; ".join(failed))
    del params32, frames32, k32, p32
    torch.cuda.empty_cache()

    line(phase, **path_times(cfg, params, prompt, fed, frames))
    profile_prefill(cfg, params, toks, phase=phase, table=f"profile_prefill_{phase}.txt", frames=frames)
    replayed, _ = steps_line(cfg, params, prompt, tokens, logits, steps, path, frames, eager)
    captured = capture(cfg, params, toks) if capture is not None else None
    del params, steps, path
    torch.cuda.empty_cache()
    return counts, replayed, captured


# ------------------------------------------------------------ int8 codec
# the reference kernel test's tolerance (tests/test_kernels.py:27-30,44): q
# within one step, under 1 % of entries differing, scale rtol 1e-6, and
# dequantize within one step of q (max scale) + 1e-3
CODEC_Q_STEP, CODEC_Q_SHARE, CODEC_SCALE_RTOL = 1, 0.01, 1e-6


def _codec_bound(T, C, in_bytes, out_bytes):
    return bound_ms(T * C * (in_bytes + out_bytes) + 4 * C, 0.0)


def _codec_case(name, x, q, s, outs, rec):
    """Hold the kernels' (q, scale) and ``outs`` (their dequantized values,
    one tensor per output dtype) against the plain version and the host
    codec (``core/codec.py``) on the same input; one line; raise outside
    the reference's tolerance."""
    import numpy as np
    import torch

    from repro_torch.core.codec import dequantize_int8, quantize_int8
    from repro_torch.kernels.kv_codec import dequantize_ref, quantize_ref

    qr, sr = quantize_ref(x)
    hq, hs = quantize_int8(x.float().cpu().numpy())  # bf16 and f16 are exact in f32
    worst_step, worst_share, diffs, sdiff = 0, 0.0, {}, {}
    for label, wq, ws in (("plain", qr, sr), ("host", torch.from_numpy(hq).to(q.device),
                                              torch.from_numpy(hs).to(q.device))):
        dq = (q.int() - wq.int()).abs()
        diffs[label] = int((dq > 0).sum())
        step, share = int(dq.max()), float((dq > 0).float().mean())
        srel = float(((s - ws).abs() / ws.abs()).max())
        sdiff[label] = srel
        if step > CODEC_Q_STEP or share >= CODEC_Q_SHARE or srel > CODEC_SCALE_RTOL:
            raise AssertionError(f"kv_codec {name}: quantize vs {label}: max |dq| {step}, {share:.4%} differ, "
                                 f"scale rel err {srel:.2e}")
        worst_step, worst_share = max(worst_step, step), max(worst_share, share)
    atol = float(s.max()) + 1e-3
    d_host = torch.from_numpy(dequantize_int8(hq, hs, np.float32)).to(q.device)
    derr = {"plain": max(max_err(d, dequantize_ref(q, s, d.dtype)) for d in outs),
            "host": max(max_err(d, d_host) for d in outs)}
    if max(derr.values()) > atol:
        raise AssertionError(f"kv_codec {name}: dequantize off by {derr} (atol {atol:.4g})")
    rec["q_max_step"] = max(rec.get("q_max_step", 0), worst_step)
    rec["q_differing"] = rec.get("q_differing", 0) + diffs["plain"] + diffs["host"]
    rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0), float(worst_step))
    rec["dequant_max_abs_err"] = max(rec.get("dequant_max_abs_err", 0.0), derr["plain"])
    line("kv_codec", case=name, shape="x".join(map(str, x.shape)), dtype=str(x.dtype).replace("torch.", ""),
         out="/".join(str(d.dtype).replace("torch.", "") for d in outs),
         q_differing_vs_plain=diffs["plain"], q_differing_vs_host=diffs["host"], q_max_step=worst_step,
         scale_rel_err_vs_plain=f"{sdiff['plain']:.2e}", scale_rel_err_vs_host=f"{sdiff['host']:.2e}",
         dequant_err_vs_plain=f"{derr['plain']:.3e}", dequant_err_vs_host=f"{derr['host']:.3e}",
         tol=f"|dq|<={CODEC_Q_STEP},<{CODEC_Q_SHARE:.0%},scale_rtol{CODEC_SCALE_RTOL},dequant_atol{atol:.4g}")


def _codec_times(rec_q, rec_d, key, x, out_dtype, iters):
    """Device times of both kernels and their plain versions on ``x``, of
    ``torch.mul(q, s, out=out)`` beside dequantize (one PyTorch call of the
    same function, f32 product rounded once to out's dtype; a yardstick the
    port never calls; none computes quantize's absmax and quantize in one
    call), and their bounds; into rec_q[key] and rec_d[key].  Prints the
    plan each kernel launches."""
    import torch

    from repro_torch.kernels.kv_codec import (dequantize, dequantize_ref, plan_for_dequantize, plan_for_quantize,
                                              quantize, quantize_ref)

    T, C = x.reshape(-1, x.shape[-1]).shape
    q, s = quantize(x)
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    if not torch.equal(torch.mul(q, s, out=out), dequantize_ref(q, s, out_dtype)):
        raise AssertionError("kv_codec: torch.mul(q, s, out=out) is not the function dequantize computes")
    out_bytes = {"torch.float16": 2, "torch.bfloat16": 2, "torch.float32": 4}[str(out_dtype)]
    for rec, fn, plain, library, bound in (
        (rec_q, lambda: quantize(x), lambda: quantize_ref(x), None, _codec_bound(T, C, x.element_size(), 1)),
        (rec_d, lambda: dequantize(q, s, out_dtype=out_dtype), lambda: dequantize_ref(q, s, out_dtype),
         lambda: torch.mul(q, s, out=out), _codec_bound(T, C, 1, out_bytes)),
    ):
        entry = rec.setdefault(key, {}) if key else rec
        entry.update(ms=graph_ms(fn, iters), plain_ms=graph_ms(plain, max(1, iters // 4)),
                     bound_ms=bound[0], bound_by=bound[1],
                     library_ms=graph_ms(library, iters) if library else None)
        entry.setdefault("shape", f"{T}x{C} {str(x.dtype).replace('torch.', '')}")
    line("kv_codec", plans=key or "serve block",
         **{f"{name}_{k}": v for name, plan in (("quantize", plan_for_quantize(x)),
                                                ("dequantize", plan_for_dequantize(q, s, out_dtype)))
            for k, v in plan._asdict().items()})
    for name, rec in (("quantize", rec_q), ("dequantize", rec_d)):
        e = rec[key] if key else rec
        lib = "null" if e["library_ms"] is None else f"{e['library_ms']:.5f}"
        line("kv_codec", kernel=name, timing=key or "serve block", shape=e["shape"], kernel_ms=f"{e['ms']:.5f}",
             plain_ms=f"{e['plain_ms']:.5f}", library_ms=lib, bound_ms=f"{e['bound_ms']:.5f}",
             bound_by=e["bound_by"], of_bound=f"{e['ms'] / e['bound_ms']:.2f}x")


def phase_kv_codec(serve_blocks, slab):
    """The codec's entry points on the KV state the port's models produce:
    ``serve_blocks`` (numpy float16 blocks of one full-width qwen3-14b
    prefill, as the serve hook hands them to the store) and ``slab``
    (minicpm3-4b's latent cache, bf16, on the card).  Returns the two
    kernels' records and the launch counts of the path run."""
    import torch

    from repro_torch import kernels
    from repro_torch.kernels.kv_codec import dequantize, dequantize_ref, quantize, quantize_ref

    blocks = [torch.from_numpy(b).to("cuda") for b in serve_blocks]
    line("kv_codec", serve_blocks=len(blocks), block_shape="x".join(map(str, blocks[0].shape)),
         block_dtype=str(blocks[0].dtype).replace("torch.", ""), slab_shape="x".join(map(str, slab.shape)),
         slab_dtype=str(slab.dtype).replace("torch.", ""))

    # the path: encode every block and the slab, decode them back
    kernels.reset_launch_counts()
    path = []
    for x in blocks + [slab]:
        q, s = quantize(x)
        path.append((x, q, s, dequantize(q, s, out_dtype=x.dtype)))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    n = len(blocks) + 1
    want = {**dict.fromkeys(KERNELS, 0), "quantize": n, "dequantize": n}
    line("kv_codec", launches=json.dumps(counts).replace(" ", ""))
    if counts != want:
        raise AssertionError(f"kv_codec: launch counts {counts}, expected {want}")

    rec_q, rec_d = {}, {}
    for i, (x, q, s, d) in enumerate(path):
        _codec_case(f"serve block {i}" if i < len(blocks) else "minicpm3 latent slab", x, q, s, [d], rec_q)
    g = torch.Generator(device="cuda").manual_seed(4)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").mul_(4).to(dtype)

    cases = [("kernels_micro", randn(256, 8192))]
    for shape in ((4, 8, 128), (3, 5, 96)):
        cases += [("leading axes", randn(*shape, dtype=dt)) for dt in (torch.bfloat16, torch.float32, torch.float16)]
    zero = randn(64, 300, dtype=torch.float32)
    zero[:, 7] = 0.0
    cases.append(("zero channel", zero))
    for name, x in cases:
        q, s = quantize(x)
        outs = [dequantize(q, s, out_dtype=out) for out in (torch.bfloat16, torch.float32, torch.float16)]
        _codec_case(name, x, q, s, outs, rec_q)
    if float(quantize(zero)[1][7]) != 1.0:
        raise AssertionError("kv_codec: an all-zero channel must get scale 1.0")
    rec_d["max_abs_err"] = rec_q["dequant_max_abs_err"]

    _codec_times(rec_q, rec_d, None, blocks[0], torch.float16, 200)
    _codec_times(rec_q, rec_d, "slab", slab, torch.bfloat16, 200)
    large = randn(4096, 8192)
    # split-T cuts the rows into slabs: the max over them is the same max, so bit for bit
    q, s = quantize(large)
    qr, sr = quantize_ref(large)
    same = {"q": torch.equal(q, qr), "scale": torch.equal(s, sr),
            "dequant": torch.equal(dequantize(q, s, out_dtype=torch.bfloat16), dequantize_ref(q, s, torch.bfloat16))}
    line("kv_codec", case="large 4096x8192 bf16", **{f"{k}_equal_plain": v for k, v in same.items()})
    if not all(same.values()):
        raise AssertionError(f"kv_codec: 4096x8192 differs from the plain version bit for bit: {same}")
    del q, s, qr, sr
    _codec_times(rec_q, rec_d, "large", large, torch.bfloat16, 20)
    line("kv_codec", summary="all cases", q_max_step=rec_q["q_max_step"], q_differing=rec_q["q_differing"],
         dequant_max_abs_err=f"{rec_q['dequant_max_abs_err']:.3e}")
    del blocks, path, large
    torch.cuda.empty_cache()
    return rec_q, rec_d, counts


# -------------------------------------------------------------------- adamw
ADAMW_SOURCE = "src/repro_torch/kernels/adamw/csrc/adamw.cu"
ADAMW_KERNELS = ("sq_norm", "adamw_update", "factored_stats")
# the fused AdamW's kernels (kernels/adamw) against their plain versions on
# the card, at qwen3-14b's full-width leaves as train_optimizer_check draws
# them (one block's wq, w_down and attn_norm, the 1-D final norm) and at
# lm_head (5120 x 151936, 0.78 B entries, the largest leaf), from a state at
# step 7, on the three optimizer paths of the reference's configs
ADAMW_LEAVES = {"wq": (1, 5120, 5120), "w_down": (1, 17408, 5120), "attn_norm": (1, 5120), "final_norm": (5120,),
                "lm_head": (5120, 151936)}
ADAMW_PATHS = (("f32 moments", "float32", False), ("bf16 m", "bfloat16", False),
               ("bf16 m, factored v", "bfloat16", True))
ADAMW_TIMED = "lm_head"
# kernel and plain version do the same f32 operations element by element,
# each rounded alike (no FMA contraction), so p, m and v agree bit for bit
# where their inputs do; the sums (norm, factored means) are f64 in another
# order, rounded once: the norm within ADAMW_NORM_RTOL, vr, vc and the
# divisor within the optimizer check's rtol, and what reads them (p, m)
# within one bf16 step
ADAMW_NORM_RTOL = 1e-12
# operations an element, for the bound: f32 (clip 1, m 3, v 4, v^ 1, the
# update 7, sqrt and division counted as one), f64 for the sums
ADAMW_OPS = {"sq_norm": 2, "factored_stats": 4, "adamw_update": 17}
F32_FLOP_PER_S = 67e12  # f32 outside the tensor cores, H100 SXM (NVIDIA's data sheet)
F64_FLOP_PER_S = 34e12  # f64 outside the tensor cores, H100 SXM (NVIDIA's data sheet)


def _adamw_bound(kernel: str, n: int, p_bytes: int, m_bytes: int, v_bytes: int, factors: int):
    """(ms, by) of one kernel over a leaf of ``n`` entries: each input read
    once, each output written once (``factors``: the entries of vr and vc,
    beside them the divisor and the step's 4 scalars), against its
    operations."""
    if kernel == "sq_norm":
        nbytes, rate = p_bytes * n + 8, F64_FLOP_PER_S
    elif kernel == "factored_stats":
        nbytes, rate = p_bytes * n + 2 * 4 * factors + 4 + 16, F64_FLOP_PER_S
    else:
        nbytes, rate = (3 * p_bytes + 2 * m_bytes + 2 * v_bytes) * n + 4 * factors + 4 + 16, F32_FLOP_PER_S
    return bound_ms(nbytes, ADAMW_OPS[kernel] * n, rate)


def _adamw_inputs(ocfg, gen):
    """Every leaf of ADAMW_LEAVES on the card: bf16 p (scale D^-1/2) and g
    (scale 1e-4: the clip acts), m (scale 1e-4, the path's dtype), v or vr
    and vc (uniform, 1e-8)."""
    import torch

    from repro_torch.training import optim

    mdt = torch.bfloat16 if ocfg.moment_dtype == "bfloat16" else torch.float32

    def randn(shape, scale, dtype):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    leaves = {}
    for name, shape in ADAMW_LEAVES.items():
        leaf = {"p": randn(shape, 5120**-0.5, torch.bfloat16), "g": randn(shape, 1e-4, torch.bfloat16),
                "m": randn(shape, 1e-4, mdt)}
        if ocfg.factored_second_moment and optim._is_factored(shape):
            leaf["vr"] = torch.rand(shape[:-1], generator=gen, device="cuda") * 1e-8
            leaf["vc"] = torch.rand(shape[:-2] + shape[-1:], generator=gen, device="cuda") * 1e-8
        else:
            leaf["v"] = torch.rand(shape, generator=gen, device="cuda") * 1e-8
        leaves[name] = leaf
    return leaves


def _adamw_step(leaf, scalars, ocfg, plain: bool):
    """One step of ``leaf`` (a dict of its tensors, updated in place) through
    the kernels or their plain versions; returns the factored divisor."""
    from repro_torch.kernels import adamw

    b1, b2 = ocfg.betas
    denom = None
    if "vr" in leaf:
        if plain:
            import torch

            denom = torch.empty(leaf["g"].shape[:-2], dtype=torch.float32, device="cuda")
            adamw.factored_stats_ref(leaf["g"], leaf["vr"], leaf["vc"], denom, scalars, b2)
        else:
            denom = adamw.factored_stats(leaf["g"], leaf["vr"], leaf["vc"], scalars, b2)
    if plain:
        adamw.adamw_update_ref(leaf["p"], leaf["g"], leaf["m"], leaf.get("v"), leaf.get("vr"), leaf.get("vc"), denom,
                               scalars, b1, b2, ocfg.eps, ocfg.weight_decay, leaf["p"].dim() >= 2)
    else:
        adamw.adamw_update(leaf["p"], leaf["g"], leaf["m"], leaf.get("v"), scalars, b1=b1, b2=b2, eps=ocfg.eps,
                           weight_decay=ocfg.weight_decay, vr=leaf.get("vr"), vc=leaf.get("vc"), denom=denom)
    return denom


def _adamw_times(leaf, scalars, ocfg, recs, path):
    """Device ms (CUDA-graph replay) of each kernel on ``leaf``, of its plain
    version, and on the f32 path of torch._fused_adamw_ on f32 copies of p
    and g with the same f32 m and v (a yardstick the port never calls: its
    own rounding, and 28 bytes an entry against the kernel's 22); into
    recs[kernel][path]."""
    import torch

    from repro_torch.kernels import adamw

    p, g, m = leaf["p"], leaf["g"], leaf["m"]
    b1, b2 = ocfg.betas
    factored = "vr" in leaf
    n, v_bytes = p.numel(), 0 if factored else 4
    factors = leaf["vr"].numel() + leaf["vc"].numel() if factored else 0
    plain = {k: t.clone() for k, t in leaf.items()}
    denom = adamw.factored_stats(g, leaf["vr"], leaf["vc"], scalars, b2) if factored else None
    plain_denom = denom.clone() if factored else None
    cases = {"adamw_update": (
        lambda: adamw.adamw_update(p, g, m, leaf.get("v"), scalars, b1=b1, b2=b2, eps=ocfg.eps,
                                   weight_decay=ocfg.weight_decay, vr=leaf.get("vr"), vc=leaf.get("vc"), denom=denom),
        lambda: adamw.adamw_update_ref(plain["p"], g, plain["m"], plain.get("v"), plain.get("vr"), plain.get("vc"),
                                       plain_denom, scalars, b1, b2, ocfg.eps, ocfg.weight_decay, p.dim() >= 2))}
    if path == ADAMW_PATHS[0][0]:
        cases["sq_norm"] = (lambda: adamw.sq_norms([g]), lambda: adamw.sq_norm_ref(g))
    if factored:
        cases["factored_stats"] = (lambda: adamw.factored_stats(g, leaf["vr"], leaf["vc"], scalars, b2),
                                   lambda: adamw.factored_stats_ref(g, plain["vr"], plain["vc"], plain_denom, scalars,
                                                                    b2))
    for kernel, (fn, plain_fn) in cases.items():
        ms, by = _adamw_bound(kernel, n, p.element_size(), m.element_size(), v_bytes, factors)
        rec = {"shape": f"{ADAMW_TIMED} {'x'.join(map(str, p.shape))} bf16, m {str(m.dtype)[6:]}",
               "ms": graph_ms(fn, 5, 3), "plain_ms": graph_ms(plain_fn, 2, 3), "bound_ms": ms, "bound_by": by,
               "library_ms": None}
        if kernel == "sq_norm":  # one call: the f64 sum of squares, and its root
            rec["library_ms"] = graph_ms(lambda: torch.linalg.vector_norm(g, dtype=torch.float64), 5, 3)
            rec["library"] = "torch.linalg.vector_norm(g, dtype=float64)"
        if kernel == "adamw_update" and "v" in leaf and m.dtype == torch.float32:
            p32, g32, m32, v32 = p.float(), g.float(), m.clone(), leaf["v"].clone()
            steps = torch.full((), 8.0, device="cuda")
            lr = float(scalars[1])
            rec["library_ms"] = graph_ms(lambda: torch._fused_adamw_(
                [p32], [g32], [m32], [v32], [], [steps], lr=lr, beta1=b1, beta2=b2, weight_decay=ocfg.weight_decay,
                eps=ocfg.eps, amsgrad=False, maximize=False), 5, 3)
            rec["library"] = "torch._fused_adamw_ on f32 copies of p and g, f32 m and v (28 B an entry)"
            del p32, g32, m32, v32
        recs.setdefault(kernel, {})[path] = rec
        line("adamw", kernel=kernel, path=path.replace(" ", "_"), shape=rec["shape"].replace(" ", "_"),
             kernel_ms=f"{rec['ms']:.4f}", plain_ms=f"{rec['plain_ms']:.4f}",
             library_ms="null" if rec["library_ms"] is None else f"{rec['library_ms']:.4f}",
             bound_ms=f"{ms:.4f}", bound_by=by, of_bound=f"{rec['ms'] / ms:.2f}x")
    del plain
    torch.cuda.empty_cache()


def phase_adamw():
    """The fused AdamW's three kernels against their plain versions on the
    card, on every path, at ADAMW_LEAVES; then each kernel's device time
    at lm_head against its bound, its plain version and one PyTorch call.
    Returns {kernel: record} for the kernels line: max |err| over every
    path and leaf, the f32 path's times (the factored kernel's from its
    path), every path's in ``paths``."""
    import dataclasses

    import torch

    from repro_torch.kernels import adamw
    from repro_torch.training import optim

    t0 = time.perf_counter()
    base = optim.OptimizerConfig(warmup_steps=2, total_steps=50)
    step = torch.tensor(8, dtype=torch.int32, device="cuda")  # the step taken: state at 7
    t = step.float()
    errs = {"sq_norm": 0.0, "factored_stats": 0.0, "adamw_update": 0.0}
    times = {}
    for path, mdt, factored in ADAMW_PATHS:
        ocfg = dataclasses.replace(base, moment_dtype=mdt, factored_second_moment=factored)
        leaves = _adamw_inputs(ocfg, torch.Generator(device="cuda").manual_seed(SEED))
        grads = [leaf["g"] for leaf in leaves.values()]
        norms = adamw.sq_norms(grads)
        plain_norms = torch.stack([adamw.sq_norm_ref(g) for g in grads])
        norm_err = float(((norms - plain_norms).abs() / plain_norms).max())
        errs["sq_norm"] = max(errs["sq_norm"], float((norms - plain_norms).abs().max()))
        gnorm = torch.sqrt(norms.sum().to(torch.float32))
        b1, b2 = ocfg.betas
        scalars = torch.stack([torch.clamp(ocfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0),
                               optim.lr_schedule(ocfg, step), 1 - b1**t, 1 - b2**t])
        worst = {"p_steps": 0.0, "m_steps": 0.0, "state_rel": 0.0, "p_equal": 0, "entries": 0}
        for name, leaf in leaves.items():
            plain = {k: v.clone() for k, v in leaf.items()}
            p0 = leaf["p"].clone()
            denom = _adamw_step(leaf, scalars, ocfg, False)
            plain_denom = _adamw_step(plain, scalars, ocfg, True)
            torch.cuda.synchronize()
            state = [(k, leaf[k], plain[k]) for k in ("v", "vr", "vc") if k in leaf]
            if denom is not None:
                state.append(("denom", denom, plain_denom))
            for k, a, b in state:
                rel = float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
                worst["state_rel"] = max(worst["state_rel"], rel)
                kernel = "factored_stats" if k in ("vr", "vc", "denom") else "adamw_update"
                errs[kernel] = max(errs[kernel], float((a - b).abs().max()))
            d = (leaf["p"].float() - plain["p"].float()).abs()
            worst["p_steps"] = max(worst["p_steps"], float((d / _bf16_step(torch.maximum(p0.abs(),
                                                                                         plain["p"].abs()))).max()))
            worst["p_equal"] += int((d == 0).sum())
            worst["entries"] += d.numel()
            dm = (leaf["m"].float() - plain["m"].float()).abs()
            if leaf["m"].dtype == torch.bfloat16:
                worst["m_steps"] = max(worst["m_steps"], float((dm / _bf16_step(plain["m"])).max()))
            else:
                worst["state_rel"] = max(worst["state_rel"], float((dm / plain["m"].abs().clamp(min=1e-30)).max()))
            errs["adamw_update"] = max(errs["adamw_update"], float(d.max()), float(dm.max()))
            del plain, p0
        line("adamw", check=f"kernels vs plain versions on the card, {path}".replace(" ", "_"),
             leaves=",".join(ADAMW_LEAVES), entries=worst["entries"], grad_norm=f"{float(gnorm):.6f}",
             clip_scale=f"{float(scalars[0]):.6f}", norm_max_rel_err=f"{norm_err:.3e}", norm_rtol=ADAMW_NORM_RTOL,
             state_max_rel_err=f"{worst['state_rel']:.3e}", state_rtol=OPT_STATE_RTOL,
             p_max_bf16_steps=f"{worst['p_steps']:.3f}", m_max_bf16_steps=f"{worst['m_steps']:.3f}",
             p_bitwise_share=f"{worst['p_equal'] / worst['entries']:.6f}")
        if (norm_err > ADAMW_NORM_RTOL or worst["state_rel"] > OPT_STATE_RTOL or worst["p_steps"] > 1
                or worst["m_steps"] > 1 or not math.isfinite(float(gnorm)) or float(scalars[0]) >= 1.0):
            raise AssertionError(f"adamw: a kernel disagrees with its plain version ({path}): {worst}, "
                                 f"norm {norm_err:.3e}")
        _adamw_times(leaves[ADAMW_TIMED], scalars, ocfg, times, path)
        del leaves, grads
        torch.cuda.empty_cache()
    f32 = ADAMW_PATHS[0][0]
    recs = {}
    for kernel, by_path in times.items():
        main = by_path.get(f32) or next(iter(by_path.values()))
        recs[kernel] = dict(main, max_abs_err=errs[kernel], paths=by_path)
    line("adamw", seconds=f"{time.perf_counter() - t0:.1f}")
    return recs


# ----------------------------------------------------------------- training
# qwen3-14b at full width, depth cut: 8 of 40 layers is 4.20 B parameters,
# whose bf16 weights and gradients and f32 AdamW moments take 50.4 GB of
# the card's 80; 40 layers would take ~177 GB
TRAIN_LAYERS = 8
TRAIN_STEPS = 4
TRAIN_TIMED_REPLAYS = 3  # the captured step's replays timed after the TRAIN_STEPS + 1 compared
TRAIN_LEAN_STEPS = 2  # eager steps with bf16 m and a factored v
TRAIN_BATCH, TRAIN_SEQ = 8, 128  # the train loop's DataConfig
GRAD_LAYERS = 2  # the bf16-vs-f32 gradient check: both copies and their gradients fit beside each other
# bf16 gradients against those of an f32 copy of the same weights: the share
# the model phases allow bf16 logits (LOGIT_REL_TOL), per leaf, as a norm
GRAD_REL_TOL = 0.05
# the optimizer on the card against the CPU: both run the same f32
# operations as separate kernels; the reductions (gradient norm, factored
# means) sum in another order
OPT_STATE_RTOL = 1e-6
OPT_ULP_SHARE = 1e-3  # bf16 parameters: one step apart on under 0.1 % of entries
# the reference's crash-resume tolerance (tests/test_training.py:118)
RESUME_RTOL, RESUME_ATOL = 1e-5, 1e-6


def _named_leaves(tree, prefix=""):
    """(dotted name, leaf) in tree_flatten order."""
    if isinstance(tree, dict):
        return [nl for k in sorted(tree) for nl in _named_leaves(tree[k], f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def _train_batch(cfg, step: int):
    import torch

    from repro_torch.training.data import DataConfig, SyntheticLM

    data = SyntheticLM(DataConfig(cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=SEED))
    return {k: torch.from_numpy(v).to("cuda") for k, v in data.batch_at(step).items()}


def _state_gb(state) -> float:
    from repro_torch.models.common import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(state)) / 1e9


def train_grad_check(base):
    """(b) bf16 gradients of a 2-layer full-width qwen3-14b on one batch
    against the gradients of an f32 copy of the same weights, leaf by leaf;
    and the embedding's backward in bf16 (the gather's, as the model takes
    it, and F.embedding's) against an f32 accumulation of the same
    upstream gradient."""
    import dataclasses

    import torch

    from repro_torch.models import api
    from repro_torch.training.loop import loss_and_grads

    cfg = dataclasses.replace(base, n_layers=GRAD_LAYERS)
    params = api.init_params(cfg, SEED, "cuda")
    batch = _train_batch(cfg, 0)
    lfn = api.loss_fn(cfg, plain_kernels=True)
    loss16, _, g16 = loss_and_grads(lfn, params, batch)
    params32 = f32_tree(params)
    loss32, _, g32 = loss_and_grads(lfn, params32, batch)
    del params32
    names = [n for n, _ in _named_leaves(params)]
    gaps = {n: float((a.float() - b).norm() / b.norm()) for n, a, b in zip(names, g16, g32)}
    worst = max(gaps, key=gaps.get)
    line("train", check=f"bf16 gradients vs an f32 copy of the weights, qwen3-14b {GRAD_LAYERS} of "
         f"{base.n_layers} layers at full width, one {TRAIN_BATCH}x{TRAIN_SEQ} batch",
         params=sum(t.numel() for t in g16), loss_bf16=f"{float(loss16):.5f}", loss_f32=f"{float(loss32):.5f}",
         worst_leaf=worst, worst_rel_gap=f"{gaps[worst]:.4e}", embed_rel_gap=f"{gaps['embed']:.4e}",
         tol=GRAD_REL_TOL)
    line("train", rel_gaps=",".join(f"{n}:{g:.3e}" for n, g in gaps.items()))
    del g16, g32, params
    torch.cuda.empty_cache()

    # the embedding's backward in bf16: indexing (index_put_ with accumulate,
    # as embed_tokens' gather differentiates) and F.embedding's own backward,
    # each against an f32 index_add_ of the same bf16 upstream gradient
    ids = batch["tokens"].reshape(-1).long()
    V, D = base.vocab_size, base.d_model
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dx = torch.randn((ids.numel(), D), generator=gen, device="cuda").to(torch.bfloat16)
    want = torch.zeros((V, D), device="cuda").index_add_(0, ids, dx.float())
    table = torch.zeros((V, D), dtype=torch.bfloat16, device="cuda", requires_grad=True)
    (g_index,) = torch.autograd.grad(table[ids], table, dx)
    g_embed = torch.ops.aten.embedding_dense_backward(dx, ids, V, -1, False)
    rel = {k: float((g.float() - want).norm() / want.norm()) for k, g in (("index", g_index), ("embedding", g_embed))}
    counts = torch.bincount(ids, minlength=V)
    line("train", check="embedding backward in bf16 vs f32 accumulation of the same upstream gradient",
         tokens=ids.numel(), distinct=int((counts > 0).sum()), max_repeats=int(counts.max()),
         index_put_rel_gap=f"{rel['index']:.4e}", embedding_backward_rel_gap=f"{rel['embedding']:.4e}")
    del want, table, g_index, g_embed, dx
    torch.cuda.empty_cache()
    if gaps[worst] > GRAD_REL_TOL or not all(map(torch.isfinite, (loss16, loss32))):
        raise AssertionError(f"train: bf16 gradient of {worst} is {gaps[worst]:.3e} from the f32 one "
                             f"(limit {GRAD_REL_TOL})")


def train_optimizer_check():
    """(c) one apply_updates on the card against the same on the CPU, on
    the full-width leaves of one qwen3-14b block (wq, w_down, attn_norm) and
    the 1-D final norm, from a state at step 7, with f32 moments and with
    bf16 m and a factored v."""
    import dataclasses

    import torch

    from repro_torch.models.common import tree_flatten, tree_unflatten
    from repro_torch.training import optim

    D, F = 5120, 17408
    shapes = {"blocks": {"attn": {"wq": (1, D, D)}, "attn_norm": (1, D), "mlp": {"w_down": (1, F, D)}},
              "final_norm": (D,)}
    leaves, treedef = tree_flatten(shapes)
    gen = torch.Generator().manual_seed(SEED)

    def draw(scale, dtype=torch.float32, positive=False):
        out = []
        for shape in leaves:
            x = torch.rand(shape, generator=gen) if positive else torch.randn(shape, generator=gen)
            out.append((x * scale).to(dtype))
        return out

    params = draw(D**-0.5, torch.bfloat16)
    grads = draw(1e-4, torch.bfloat16)
    base = optim.OptimizerConfig(warmup_steps=2, total_steps=50)
    for label, ocfg in (("f32 moments", base),
                        ("bf16 m, factored v", dataclasses.replace(base, moment_dtype="bfloat16",
                                                                   factored_second_moment=True))):
        mdt = torch.bfloat16 if ocfg.moment_dtype == "bfloat16" else torch.float32
        m = [t.to(mdt) for t in draw(1e-4)]
        v = []
        for shape in leaves:
            if ocfg.factored_second_moment and optim._is_factored(shape):
                v.append({"vc": torch.rand(shape[:-2] + shape[-1:], generator=gen) * 1e-8,
                          "vr": torch.rand(shape[:-1], generator=gen) * 1e-8})
            else:
                v.append({"v": torch.rand(shape, generator=gen) * 1e-8})
        out = {}
        for dev in ("cuda", "cpu"):
            to = lambda ts: [t.to(dev, copy=True) for t in ts]  # noqa: E731
            p = tree_unflatten(treedef, to(params))
            state = {"step": torch.tensor(7, dtype=torch.int32, device=dev), "m": tree_unflatten(treedef, to(m)),
                     "v": tree_unflatten(treedef, [{k: t.to(dev, copy=True) for k, t in d.items()} for d in v])}
            optim.apply_updates(ocfg, p, tree_unflatten(treedef, to(grads)), state)
            out[dev] = (tree_flatten(p)[0], tree_flatten(state["m"])[0], tree_flatten(state["v"])[0])
        state_err, m_ulps, steps, differ, total = 0.0, 0, 0.0, 0, 0
        for a, b in zip(out["cuda"][1] + out["cuda"][2], out["cpu"][1] + out["cpu"][2]):
            a = a.cpu()
            if a.dtype == torch.float32:
                state_err = max(state_err, float(((a - b).abs() / b.abs().clamp(min=1e-30)).max()))
            else:  # bf16 m: the same f32 value on both, rounded once
                m_ulps = max(m_ulps, int((a.view(torch.int16).int() - b.view(torch.int16).int()).abs().max()))
        for a, b, p0 in zip(out["cuda"][0], out["cpu"][0], params):
            # in bf16 steps at the larger of the parameter before and after
            # the update: where p - lr·upd cancels to near zero (or p is near
            # zero and the update is not), an f32 difference at the operands'
            # scale is many steps of the small value
            d = (a.cpu().float() - b.float()).abs()
            steps = max(steps, float((d / _bf16_step(torch.maximum(p0.abs(), b.abs()))).max()))
            differ, total = differ + int((d > 0).sum()), total + d.numel()
        moved = sum(int((b != p0).sum()) for b, p0 in zip(out["cpu"][0], params))
        line("train", check=f"optimizer on the card vs the CPU, {label}", leaves="wq,w_down,attn_norm,final_norm",
             entries=total, state_max_rel_err=f"{state_err:.3e}", state_rtol=OPT_STATE_RTOL, m_bf16_max_ulps=m_ulps,
             params_max_bf16_steps=f"{steps:.3f}", params_differing=differ, share=f"{differ / total:.2e}",
             share_limit=OPT_ULP_SHARE, params_moved_by_the_step=moved)
        if state_err > OPT_STATE_RTOL or m_ulps > 1 or steps > 1 or differ > OPT_ULP_SHARE * total or moved < total // 2:
            raise AssertionError(f"train: the optimizer on the card disagrees with the CPU ({label})")
        del out


def _bf16_step(x):
    """The spacing of bf16 values at |x|: 2^(e - 8) for |x| in [2^(e-1), 2^e)."""
    import torch

    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), torch.frexp(x.float().abs())[1] - 8)


def _matmul_params(params) -> int:
    """Parameters that enter a matmul: the stacked 3-D block weights and
    lm_head (the embedding is a gather, the norm scales elementwise)."""
    return sum(t.numel() for n, t in _named_leaves(params) if t.dim() == 3 or n == "lm_head")


class OptimizerEvents:
    """While active, records a CUDA event just before and just after every
    ``optim.apply_updates`` call of the train step: forward+backward ms and
    optimizer ms on the device's clock.  Changes nothing it times."""

    def __enter__(self):
        import torch

        from repro_torch.training import optim

        self.optim, self.orig, self.events = optim, optim.apply_updates, []

        def timed(*args, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.orig(*args, **kw)
            end.record()
            self.events.append((start, end))
            return out

        optim.apply_updates = timed
        return self

    def __exit__(self, *exc):
        self.optim.apply_updates = self.orig


def train_steps(base):
    """(a) the train loop's step on qwen3-14b at full width, TRAIN_LAYERS
    layers, the loop's default optimizer (f32 moments), SyntheticLM batches
    from seed 0: TRAIN_STEPS eager steps and a profile of one more; then
    the same TRAIN_STEPS + 1 steps from the same state through the step
    captured as one CUDA graph, as ``train`` captures it (its first
    WARM_CALLS calls eager, the next captures and replays), gated equal to
    the eager steps bit for bit in losses and in every parameter, and
    TRAIN_TIMED_REPLAYS more replays timed and one profiled; the grad
    guard; two eager steps with bf16 m and a factored v.  Returns (the
    eager steps' median ms, the record of the captured step)."""
    import dataclasses
    import math

    import torch

    from repro_torch import graphs
    from repro_torch.models import api
    from repro_torch.models.common import count_params, tree_flatten
    from repro_torch.training import optim
    from repro_torch.training.loop import default_optimizer, loss_and_grads, make_train_step

    cfg = dataclasses.replace(base, n_layers=TRAIN_LAYERS)
    t0 = time.perf_counter()
    params = api.init_params(cfg, SEED, "cuda")
    torch.cuda.synchronize()
    n_params, n_matmul = count_params(params), _matmul_params(params)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # model FLOPs of one step: 6 per matmul parameter per token (forward and
    # backward) and causal attention counted whole, 12·L·H·Dh·S per token
    flops = 6 * n_matmul * tokens + 12 * cfg.n_layers * cfg.n_heads * cfg.d_head * TRAIN_SEQ * tokens
    line("train", arch=cfg.name, layers=f"{cfg.n_layers} of {base.n_layers}", d_model=cfg.d_model,
         heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff, vocab=cfg.vocab_size, params=n_params,
         matmul_params=n_matmul, init_params_s=f"{time.perf_counter() - t0:.2f}",
         reduced=f"n_layers {base.n_layers}->{cfg.n_layers} (optimizer state of 40 layers does not fit one card)")

    # the kernels have no backward: the train step's forward with them raises
    batch = _train_batch(cfg, 0)
    try:
        loss_and_grads(api.loss_fn(cfg, plain_kernels=False), params, batch)
    except RuntimeError as e:
        if "plain_kernels=True" not in str(e):
            raise
        line("train", check="forward through the kernels under grad raises the grad guard",
             error=str(e).split(";")[0].replace(" ", "_"))
    else:
        raise AssertionError("train: a forward through the kernels under grad did not raise")

    ocfg = default_optimizer(TRAIN_STEPS)
    state = optim.init_state(ocfg, params)
    step_fn = make_train_step(cfg, ocfg)
    f32_state_gb = _state_gb(state)
    line("train", optimizer=f"lr {ocfg.lr}, warmup {ocfg.warmup_steps}, total {ocfg.total_steps}, "
         f"moments {ocfg.moment_dtype}", state_gb=f"{f32_state_gb:.2f}",
         weights_gb=f"{sum(t.numel() * t.element_size() for _, t in _named_leaves(params)) / 1e9:.2f}",
         flops_per_step=f"{flops:.4e}", mfu_formula="(6*matmul_params*tokens+12*L*H*Dh*S*tokens)/step_s/989e12")

    def timed_step(step_fn, state, step):
        batch = _train_batch(cfg, step)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        with OptimizerEvents() as ev:
            begin = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            begin.record()
            _, state, met = step_fn(params, state, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        (o0, o1), = ev.events
        return state, met, wall, begin.elapsed_time(o0), o0.elapsed_time(o1)

    steps, losses = [], []
    for step in range(TRAIN_STEPS):
        state, met, wall, fb_ms, opt_ms = timed_step(step_fn, state, step)
        loss, gnorm = float(met["loss"]), float(met["grad_norm"])
        steps.append(wall)
        losses.append(loss)
        line("train", step=step + 1, loss=f"{loss:.5f}", grad_norm=f"{gnorm:.4f}", lr=f"{float(met['lr']):.4e}",
             step_ms=f"{wall:.3f}", fwd_bwd_ms=f"{fb_ms:.3f}", optimizer_ms=f"{opt_ms:.3f}",
             optimizer_bound_ms=f"{_optimizer_bound_ms(params, state):.3f}",
             tokens_per_s=f"{tokens / wall * 1e3:.1f}", mfu=f"{flops / (wall * 1e-3) / BF16_FLOP_PER_S:.4f}",
             peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"train: step {step + 1} has a non-finite loss or grad norm")
    warm = statistics.median(steps[1:])
    line("train", what=f"median of steps 2-{TRAIN_STEPS}", step_ms=f"{warm:.3f}",
         tokens_per_s=f"{tokens / warm * 1e3:.1f}", mfu=f"{flops / (warm * 1e-3) / BF16_FLOP_PER_S:.4f}")
    batch = _train_batch(cfg, TRAIN_STEPS)
    out = {}
    eager_wall, eager_busy, _, _ = profile_call(lambda: out.update(met=step_fn(params, state, batch)[2]), "train",
                                                "profile_train_step.txt",
                                                f"one eager train step (step {TRAIN_STEPS + 1}), under torch.profiler")
    losses.append(float(out["met"]["loss"]))
    want = [t.cpu() for t in tree_flatten(params)[0]]
    del state, params, out
    torch.cuda.empty_cache()

    # the same steps from the same state, captured as train() captures them
    params = api.init_params(cfg, SEED, "cuda")
    state = optim.init_state(ocfg, params)
    captured = graphs.capture(step_fn, params, state, _train_batch(cfg, 0), held=(0, 1), warm_on_calls=True)
    torch.cuda.reset_peak_memory_stats()
    got, walls = [], []
    for step in range(TRAIN_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, met = captured(params, state, _train_batch(cfg, step))
        got.append(float(met["loss"]))
        walls.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    recorded = {k: n for k, n in captured.launches.items() if n}
    differ = [i for i, (a, b) in enumerate(zip(tree_flatten(params)[0], want)) if not torch.equal(a.cpu(), b)]
    compared = captured.replays
    line("train", check=f"the captured step against the eager step from the same state, {TRAIN_STEPS + 1} steps: "
         f"{graphs.WARM_CALLS} warm calls, then {compared} replays".replace(" ", "_"),
         losses_captured=",".join(f"{x:.6f}" for x in got), losses_eager=",".join(f"{x:.6f}" for x in losses),
         losses_bitwise=got == losses, leaves=len(want), leaves_differing=len(differ),
         host_ms_per_call=",".join(f"{x:.3f}" for x in walls), capture_s=f"{captured.capture_s:.3f}",
         pool_gb=f"{captured.pool_bytes / 1e9:.3f}", peak_mem_gb=f"{peak_gb:.2f}",
         recorded_launches=json.dumps(recorded).replace(" ", ""))
    if got != losses or differ or compared != TRAIN_STEPS + 1 - graphs.WARM_CALLS:
        raise AssertionError(f"train: the captured step is not the eager step bit for bit: losses {got} against "
                             f"{losses}, leaves differing {differ}")
    del want

    # the captured step's time: TRAIN_TIMED_REPLAYS replays, host clock and
    # CUDA events, then one under torch.profiler with its device trace
    host, device = [], []
    for step in range(TRAIN_STEPS + 1, TRAIN_STEPS + 1 + TRAIN_TIMED_REPLAYS):
        batch = _train_batch(cfg, step)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        captured(params, state, batch)
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        device.append(start.elapsed_time(end))
    batch = _train_batch(cfg, TRAIN_STEPS + 1 + TRAIN_TIMED_REPLAYS)
    graph_wall, graph_busy, traced, _ = profile_call(lambda: captured(params, state, batch), "train",
                                                     "profile_train_step_graph.txt",
                                                     "one replay of the captured train step, under torch.profiler")
    per_replay = {k: n for k, n in traced.items() if n}
    graph_ms_ = statistics.median(host)
    rec = {"eager_step_ms": warm, "graph_step_ms": graph_ms_, "graph_device_ms": statistics.median(device),
           "eager_idle_share": max(0.0, 1 - eager_busy / eager_wall),
           "eager_idle_share_unprofiled": max(0.0, 1 - eager_busy / warm),
           "graph_idle_share": max(0.0, 1 - graph_busy / graph_wall),
           "graph_idle_share_unprofiled": max(0.0, 1 - graph_busy / graph_ms_), "pool_bytes": captured.pool_bytes,
           "per_replay": per_replay, "replays": captured.replays, "peak_mem_gb": peak_gb,
           "capture_s": captured.capture_s}
    line("train", what=f"eager against captured step, median of {TRAIN_TIMED_REPLAYS} replays".replace(" ", "_"),
         eager_step_ms=f"{warm:.3f}", graph_step_ms=f"{graph_ms_:.3f}", graph_device_ms=f"{rec['graph_device_ms']:.3f}",
         eager_busy_ms=f"{eager_busy:.3f}", graph_busy_ms=f"{graph_busy:.3f}",
         eager_idle_share=f"{rec['eager_idle_share']:.3f}", graph_idle_share=f"{rec['graph_idle_share']:.3f}",
         eager_idle_share_unprofiled=f"{rec['eager_idle_share_unprofiled']:.3f}",
         graph_idle_share_unprofiled=f"{rec['graph_idle_share_unprofiled']:.3f}",
         pool_gb=f"{captured.pool_bytes / 1e9:.3f}", tokens_per_s=f"{tokens / graph_ms_ * 1e3:.1f}",
         replays=captured.replays, launches_per_replay=json.dumps(per_replay).replace(" ", ""))
    leaves = tree_flatten(params)[0]
    want_per_replay = {"sq_norm": len(leaves), "adamw_update": len(leaves)}
    if per_replay != want_per_replay or recorded != want_per_replay:
        raise AssertionError(f"train: a replay launched {per_replay} and the capture recorded {recorded}, not "
                             f"{want_per_replay}")
    del captured, state, step_fn
    torch.cuda.empty_cache()

    # the memory options the reference gives kimi-k2: bf16 m, factored v
    ocfg = dataclasses.replace(ocfg, moment_dtype="bfloat16", factored_second_moment=True)
    state = optim.init_state(ocfg, params)
    lean_gb = _state_gb(state)
    step_fn = make_train_step(cfg, ocfg)
    for step in range(TRAIN_LEAN_STEPS):
        state, met, wall, fb_ms, opt_ms = timed_step(step_fn, state, step)
        loss, gnorm = float(met["loss"]), float(met["grad_norm"])
        line("train", options="bf16 m, factored v", step=step + 1, state_gb=f"{lean_gb:.2f}",
             f32_state_gb=f"{f32_state_gb:.2f}", loss=f"{loss:.5f}", grad_norm=f"{gnorm:.4f}", step_ms=f"{wall:.3f}",
             fwd_bwd_ms=f"{fb_ms:.3f}", optimizer_ms=f"{opt_ms:.3f}",
             optimizer_bound_ms=f"{_optimizer_bound_ms(params, state):.3f}",
             peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError("train: the step with bf16 m and a factored v is not finite")
    del state, params
    torch.cuda.empty_cache()
    return warm, rec


def _optimizer_bound_ms(params, state) -> float:
    """The least ms of one optimizer step over these leaves at HBM_BW: the
    norm reads every gradient once; the update reads p, g, m and v (or vr
    and vc) once and writes p, m and v (vr and vc) once."""
    from repro_torch.launch.mesh import HBM_BW
    from repro_torch.models.common import tree_flatten

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0])

    p = nbytes(params)
    return (p + 3 * p + 2 * nbytes(state["m"]) + 2 * nbytes(state["v"])) / HBM_BW * 1e3


def train_resume():
    """(d) examples/train_smoke_torch.py --simulate-crash on the card in a
    subprocess, deterministic algorithms on: qwen3-14b-smoke for 12 steps
    uninterrupted, then crashed after step 4 with checkpoints every 3 and
    resumed from step 3; the losses after the resume against the
    uninterrupted run's."""
    import tempfile

    import numpy as np

    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    with tempfile.TemporaryDirectory(prefix="train_resume_") as ckpt_dir:
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, os.path.join(HERE, "examples", "train_smoke_torch.py"),
                              "--simulate-crash", "--device", "cuda", "--steps", "12", "--ckpt-every", "3",
                              "--ckpt-dir", ckpt_dir], capture_output=True, text=True, env=env, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"train: the crash/resume run failed ({out.returncode}): "
                             f"{out.stdout[-1500:]} {out.stderr[-1500:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    k = res["resumed_from"]
    got, want = np.array(res["resumed"]), np.array(res["full"][k:])
    ok = k == 3 and got.shape == want.shape and bool(np.allclose(got, want, rtol=RESUME_RTOL, atol=RESUME_ATOL))
    line("train", check="crash after step 4 and resume on the card, qwen3-14b-smoke, deterministic algorithms",
         resumed_from=k, steps_compared=len(got), max_abs_gap=f"{float(np.max(np.abs(got - want))):.3e}",
         tol=f"rtol{RESUME_RTOL}+atol{RESUME_ATOL}", seconds=f"{time.perf_counter() - t0:.1f}")
    if not ok:
        raise AssertionError("train: the losses after the resume do not replay the uninterrupted run")


def optimizer_launches(cfg, steps: int, factored: bool = False):
    """Each kernel's launches over ``steps`` optimizer steps of ``cfg``'s
    leaves: one sq_norm and one adamw_update a leaf, one factored_stats a
    factored leaf where ``factored``; no other kernel."""
    from repro_torch import kernels
    from repro_torch.models import api
    from repro_torch.models.common import tree_flatten
    from repro_torch.training import optim

    shapes = [tuple(t.shape) for t in tree_flatten(api.param_specs(cfg))[0]]
    want = dict.fromkeys(kernels.launch_counts(), 0)
    want.update(sq_norm=len(shapes) * steps, adamw_update=len(shapes) * steps,
                factored_stats=sum(map(optim._is_factored, shapes)) * steps if factored else 0)
    return want


def train_launches(cfg):
    """The kernel launches of phase train's main path, (a), from ``cfg``'s
    leaf list: the eager steps (TRAIN_STEPS and the profiled one), the
    captured step's warm calls and its capture (a replay runs no wrapper)
    with f32 moments, and the TRAIN_LEAN_STEPS eager steps with a
    factored v."""
    from repro_torch import graphs

    f32 = optimizer_launches(cfg, TRAIN_STEPS + 1 + graphs.WARM_CALLS + 1)
    lean = optimizer_launches(cfg, TRAIN_LEAN_STEPS, factored=True)
    return {k: f32[k] + lean[k] for k in f32}


def phase_train():
    """The port's training path on the card: (b) gradients, (c) the
    optimizer, (a) full-width steps, eager and captured, and the memory
    options, (d) crash and resume.  The launch counters are reset just
    before (a) and read just after: the fused AdamW's kernels launch
    exactly as ``train_launches`` reckons from the leaf list (forward and
    backward run the plain versions, as the reference trains through its
    plain attention and scans).  Returns (the median eager step ms of (a),
    the captured step's record, the counts)."""
    import dataclasses

    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config

    base = get_config(ARCH)
    train_grad_check(base)
    train_optimizer_check()
    kernels.reset_launch_counts()
    step_ms, graph = train_steps(base)
    counts = kernels.launch_counts()
    want = train_launches(dataclasses.replace(base, n_layers=TRAIN_LAYERS))
    line("train", launches=json.dumps(counts).replace(" ", ""), expected=json.dumps(want).replace(" ", ""))
    if counts != want:
        raise AssertionError(f"train: the main path launched {counts}, not {want}")
    train_resume()
    torch.cuda.empty_cache()
    return step_ms, graph, counts


# ---------------------------------------------------------------- distributed
# (b): |dequant(q) - (g + e)| <= scale/2 holds for the exact quotient; the
# f32 quotient g'/scale and the f32 product q·scale each round once, adding
# at most 127·scale·2^-24 apiece, so the gate allows scale·(1/2 + 2^-16)
COMPRESS_SLACK = 2.0**-16
COMPRESS_BYTES, REDUCE_BYTES = 11, 5  # per entry: g bf16 + e f32 in, q + e out; q in, the f32 mean out
GLOO_RANKS = 4
DIST_STEPS = 2


def _card_bytes(shardings, specs):
    """{mesh coordinate: bytes it holds of a tree of specs}."""
    from repro_torch.models.common import tree_leaves

    totals = {}
    for sh, x in zip(tree_leaves(shardings), tree_leaves(specs)):
        for coord, sl in sh.shard_slices(tuple(x.shape)).items():
            totals[coord] = totals.get(coord, 0) + math.prod(s.stop - s.start for s in sl) * x.element_size()
    return totals


def dist_rules():
    """(a) The full 40-layer qwen3-14b's parameters and f32 AdamW state per
    card on the (16, 16) production mesh, reckoned from ``shard_slices``
    (a count, not a timing)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.distributed.sharding import AbstractMesh, axis_sizes
    from repro_torch.launch import steps
    from repro_torch.models.common import tree_leaves

    cfg = get_config(ARCH)
    mesh = AbstractMesh((16, 16), ("data", "model"))
    ocfg = steps.opt_config_for(cfg)
    p_specs, o_specs, _ = steps.train_abstract_inputs(cfg, SHAPES["train_4k"], ocfg)
    (p_sh, o_sh, _), _ = steps.train_shardings(mesh, cfg, SHAPES["train_4k"], ocfg)
    p_bytes, o_bytes = _card_bytes(p_sh, p_specs), _card_bytes(o_sh, o_specs)
    per = {c: (p_bytes[c], o_bytes[c]) for c in p_bytes}
    worst = max(per, key=lambda c: sum(per[c]))
    whole = [sum(x.numel() * x.element_size() for x in tree_leaves(t)) for t in (p_specs, o_specs)]
    line("distributed", part="a", arch=cfg.name, layers=cfg.n_layers, mesh=json.dumps(axis_sizes(mesh)).replace(" ", ""),
         moments=ocfg.moment_dtype, params_gb=f"{whole[0] / 1e9:.2f}", opt_state_gb=f"{whole[1] / 1e9:.2f}",
         per_card_params_gb=f"{per[worst][0] / 1e9:.4f}", per_card_opt_state_gb=f"{per[worst][1] / 1e9:.4f}",
         per_card_share=f"{sum(per[worst]) / sum(whole):.5f}", cards=len(per),
         note="count_from_shard_slices_not_a_timing")
    return per[worst]


def dist_compression(mesh, step_ms):
    """(b) The gradients of one full-width qwen3-14b forward and backward,
    TRAIN_LAYERS of 40 layers, through compress_grads and the all-reduce
    over NCCL at world size 1, leaf by leaf: a first pass fills the
    residuals (and starts NCCL's communicator, which the first collective
    does), the second is timed (CUDA events) and gated."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import compression as cmp
    from repro_torch.models import api
    from repro_torch.training.loop import loss_and_grads

    cfg = dataclasses.replace(get_config(ARCH), n_layers=TRAIN_LAYERS)
    params = api.init_params(cfg, SEED, "cuda")
    names = [n for n, _ in _named_leaves(params)]
    _, _, grads = loss_and_grads(api.loss_fn(cfg, plain_kernels=True), params, _train_batch(cfg, 0))
    del params
    torch.cuda.empty_cache()
    entries = sum(g.numel() for g in grads)
    res = [torch.zeros(g.shape, dtype=torch.float32, device="cuda") for g in grads]
    for i, g in enumerate(grads):
        res[i] = cmp.allreduce_compressed(mesh, {"g": g}, {"g": res[i]})[1]["g"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    compress_ms = reduce_ms = whole_ms = 0.0
    worst_share, worst_leaf = 0.0, None
    for i, (name, g) in enumerate(zip(names, grads)):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        q, s, e_new = cmp.compress_grads({"g": g}, {"g": res[i]})
        ev[1].record()
        out = cmp.allreduce_quantized(mesh, q, s)
        ev[2].record()
        red2, res2 = cmp.allreduce_compressed(mesh, {"g": g}, {"g": res[i]})
        ev[3].record()
        ev[3].synchronize()
        compress_ms += ev[0].elapsed_time(ev[1])
        reduce_ms += ev[1].elapsed_time(ev[2])
        whole_ms += ev[2].elapsed_time(ev[3])
        gf = g.float() + res[i]
        deq = cmp.dequantize_tensor(q["g"], s["g"])
        share = float((deq - gf).abs().max() / s["g"])
        if share > worst_share:
            worst_share, worst_leaf = share, name
        if share > 0.5 + COMPRESS_SLACK:
            raise AssertionError(f"distributed: {name}: |dequant(q) - (g + e)| is {share:.6f} of the scale")
        if not torch.equal(e_new["g"], gf - deq):
            raise AssertionError(f"distributed: {name}: the new residual is not g + e - dequant(q)")
        if not (torch.equal(out["g"], deq) and torch.equal(red2["g"], deq) and torch.equal(res2["g"], e_new["g"])):
            raise AssertionError(f"distributed: {name}: at world size 1 the reduced gradient is not dequant(q)")
        res[i] = e_new["g"]
        del q, s, e_new, out, red2, res2, gf, deq
    peak = torch.cuda.max_memory_allocated() / 1e9
    c_bound, _ = bound_ms(COMPRESS_BYTES * entries, 0)
    r_bound, _ = bound_ms(REDUCE_BYTES * entries, 0)
    line("distributed", part="b", what=f"compress_grads and the all-reduce over NCCL (world 1), qwen3-14b "
         f"{TRAIN_LAYERS} of 40 layers at full width, one {TRAIN_BATCH}x{TRAIN_SEQ} batch's bf16 gradients",
         leaves=len(grads), entries=entries, compress_ms=f"{compress_ms:.3f}", allreduce_ms=f"{reduce_ms:.3f}",
         allreduce_compressed_ms=f"{whole_ms:.3f}",
         compress_bound_ms=f"{c_bound:.3f}", allreduce_bound_ms=f"{r_bound:.3f}",
         bound=f"{COMPRESS_BYTES}+{REDUCE_BYTES}_bytes_per_entry_at_3.35TB/s",
         compress_x_bound=f"{compress_ms / c_bound:.2f}", allreduce_x_bound=f"{reduce_ms / r_bound:.2f}",
         residuals_gb=f"{4 * entries / 1e9:.2f}", train_step_ms=f"{step_ms:.3f}",
         compress_over_step=f"{compress_ms / step_ms:.4f}", allreduce_over_step=f"{reduce_ms / step_ms:.4f}",
         peak_mem_gb=f"{peak:.2f}", worst_err_over_scale=f"{worst_share:.6f}", worst_leaf=worst_leaf,
         gates="err<=scale*(1/2+2^-16),residual_bitwise,reduced==dequant(q)_bitwise")
    del grads, res
    torch.cuda.empty_cache()


def _gloo_inputs(rank: int):
    """Rank ``rank``'s small gradients and residuals, from the seed."""
    import numpy as np

    rng = np.random.default_rng((SEED, rank))
    shapes = {"a": (16, 8), "b": (5, 12)}
    return ({k: rng.standard_normal(s).astype(np.float32) * (rank + 1) for k, s in shapes.items()},
            {k: (rng.standard_normal(s) * 0.01).astype(np.float32) for k, s in shapes.items()})


def _gloo_rank(rank: int, store: str, out_dir: str):
    """(c) One of GLOO_RANKS gloo ranks on the one card: the compressed
    all-reduce of small gradients on CUDA tensors and on CPU tensors."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import compression as cmp
    from repro_torch.launch.mesh import make_smoke_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=GLOO_RANKS)
    try:
        mesh = make_smoke_mesh(GLOO_RANKS, 1, device="cuda")
        g, e = _gloo_inputs(rank)
        out = {}
        for dev in ("cuda", "cpu"):
            red, res = cmp.allreduce_compressed(mesh, {k: torch.from_numpy(v).to(dev) for k, v in g.items()},
                                                {k: torch.from_numpy(v).to(dev) for k, v in e.items()})
            out[dev] = {k: (red[k].cpu(), res[k].cpu(), red[k].device.type) for k in red}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _join(procs, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    if alive or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"distributed: {what}: exit codes {[p.exitcode for p in procs]}"
                             + (f", killed at {timeout} s" if alive else ""))


def dist_gloo_cuda():
    """(c) GLOO_RANKS gloo ranks on the one card: the compressed all-reduce
    on CUDA tensors equals the same run on CPU tensors bit for bit, on
    every rank."""
    import multiprocessing
    import tempfile

    import torch

    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="gloo_") as d:
        procs = [ctx.Process(target=_gloo_rank, args=(r, os.path.join(d, "store"), d)) for r in range(GLOO_RANKS)]
        for p in procs:
            p.start()
        _join(procs, 300, "the gloo ranks on CUDA tensors")
        outs = [torch.load(os.path.join(d, f"rank{r}.pt")) for r in range(GLOO_RANKS)]
    equal = all(torch.equal(o["cuda"][k][i], o["cpu"][k][i]) for o in outs for k in o["cuda"] for i in (0, 1))
    same = all(torch.equal(o["cuda"][k][0], outs[0]["cuda"][k][0]) for o in outs for k in o["cuda"])
    on_card = all(o["cuda"][k][2] == "cuda" for o in outs for k in o["cuda"])
    g = [_gloo_inputs(r)[0]["a"] for r in range(GLOO_RANKS)]
    exact = sum(g) / GLOO_RANKS
    rel = float(((outs[0]["cuda"]["a"][0].numpy() - exact) ** 2).sum() ** 0.5 / (exact**2).sum() ** 0.5)
    line("distributed", part="c", ranks=GLOO_RANKS, backend="gloo", tensors="cuda_and_cpu", leaves="16x8,5x12",
         cuda_equals_cpu_bitwise=equal, ranks_agree=same, results_on_card=on_card,
         rel_err_vs_exact_mean=f"{rel:.4e}", seconds=f"{time.perf_counter() - t0:.1f}")
    if not (equal and same and on_card and rel < 0.02):
        raise AssertionError("distributed: the compressed all-reduce on CUDA tensors over gloo differs from CPU")


def _loop_child(root: str, result: str):
    """(d) In a fresh process (deterministic algorithms, set before cuBLAS
    starts): the non-distributed loop and the data-parallel loop through
    launch/train.main --data 1 on qwen3-14b at full width, TRAIN_LAYERS
    layers, DIST_STEPS steps; then the DP run's checkpoint restored under
    the (1, 1) mesh's shardings, each leaf against the file on the card.
    The non-distributed run is one step longer with DIST_STEPS's schedule
    and stops after DIST_STEPS (``crash_after``), so it writes none of
    the 42 GB checkpoint the DP run writes."""
    import dataclasses

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import train as launcher
    from repro_torch.launch.mesh import init_process_group, make_smoke_mesh
    from repro_torch.models import api
    from repro_torch.models.common import tree_flatten
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import optim
    from repro_torch.training.loop import TrainConfig, default_optimizer, train

    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(ARCH), n_layers=TRAIN_LAYERS)
    out = {}
    t0 = time.perf_counter()
    plain = train(cfg, TrainConfig(steps=DIST_STEPS + 1, ckpt_every=DIST_STEPS + 1,
                                   ckpt_dir=os.path.join(root, "plain"), log_every=1),
                  default_optimizer(DIST_STEPS), crash_after=DIST_STEPS, device="cuda", log=lambda *_: None)
    if os.path.exists(os.path.join(root, "plain")):
        raise AssertionError("distributed: the non-distributed run wrote a checkpoint")
    out["plain_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dp_dir = os.path.join(root, "dp")
    dp = launcher.main(["--full", "--layers", str(TRAIN_LAYERS), "--steps", str(DIST_STEPS), "--ckpt-every",
                        str(DIST_STEPS), "--ckpt-dir", dp_dir, "--data", "1", "--device", "cuda"])
    out["dp_s"] = time.perf_counter() - t0
    out["plain"], out["dp"] = plain["losses"], dp["losses"]

    out["launches"] = kernels.launch_counts()
    t0 = time.perf_counter()
    assert init_process_group("cuda")
    try:
        mesh = make_smoke_mesh(1, 1, device="cuda")
        p_specs = api.param_specs(cfg)
        o_specs = optim.state_specs(default_optimizer(DIST_STEPS), p_specs)
        p_sh = shd.param_shardings(mesh, p_specs)
        like = {"params": p_specs, "opt": o_specs}
        shardings = {"params": p_sh, "opt": shd.opt_state_shardings(mesh, o_specs, p_sh)}
        got, manifest = ckpt.restore(dp_dir, DIST_STEPS, like, shardings)
        leaves, differ, nbytes = tree_flatten(got)[0], 0, 0
        with np.load(os.path.join(dp_dir, f"step_{DIST_STEPS:09d}", "shard_00000.npz")) as data:
            for i, t in enumerate(leaves):
                a = t.to_local()
                if a.dtype == torch.bfloat16:
                    a, want = a.view(torch.int16), data[f"leaf_{i:05d}__bf16"].view(np.int16)
                else:
                    want = data[f"leaf_{i:05d}"]
                differ += int(not torch.equal(a, torch.from_numpy(np.asarray(want, order="C")).to(a.device)))
                nbytes += a.numel() * a.element_size()
        out["restore"] = {"leaves": len(leaves), "differ": differ, "gb": nbytes / 1e9, "step": manifest["step"],
                          "dtensor": all(type(t).__name__ == "DTensor" for t in leaves),
                          "device": leaves[0].to_local().device.type}
    finally:
        dist.destroy_process_group()
    out["restore_s"] = time.perf_counter() - t0
    with open(result, "w") as f:
        json.dump(out, f)


def dist_rest(mesh):
    """(d) gpipe at one stage over NCCL; the data-parallel loop and the
    sharded restore (``_loop_child``, in a subprocess).  Returns the kernel
    launches of the loop's process."""
    import multiprocessing
    import tempfile

    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.pipeline import gpipe

    smesh = init_device_mesh("cuda", (1,), mesh_dim_names=("stage",))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    w = torch.randn((1, 8, 8), generator=gen, device="cuda") * 0.3
    xs = torch.randn((6, 2, 8), generator=gen, device="cuda")
    fn = lambda p, x: torch.tanh(x @ p)  # noqa: E731
    ys = gpipe(fn, smesh, axis="stage")(w, xs)
    seq = torch.stack([fn(w[0], x) for x in xs])
    line("distributed", part="d", check="gpipe at one stage over NCCL vs the stage applied to each microbatch",
         microbatches=xs.shape[0], equal_bitwise=bool(torch.equal(ys, seq)))
    if not torch.equal(ys, seq):
        raise AssertionError("distributed: gpipe at one stage differs from the stage function")

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="dist_loop_") as root:
        result = os.path.join(root, "result.json")
        p = ctx.Process(target=_loop_child, args=(root, result))
        p.start()
        _join([p], 900, "the data-parallel loop")
        with open(result) as f:
            out = json.load(f)
    r = out["restore"]
    line("distributed", part="d", check=f"launch/train.main --data 1 vs the non-distributed loop, qwen3-14b "
         f"{TRAIN_LAYERS} of 40 layers at full width, {DIST_STEPS} steps, deterministic algorithms",
         losses_dp=",".join(f"{x:.6f}" for x in out["dp"]), losses_plain=",".join(f"{x:.6f}" for x in out["plain"]),
         bitwise=out["dp"] == out["plain"], dp_s=f"{out['dp_s']:.1f}", plain_s=f"{out['plain_s']:.1f}")
    line("distributed", part="d", check="the data-parallel run's checkpoint restored under the (1,1) mesh's "
         "shardings, each leaf against the file", leaves=r["leaves"], differ=r["differ"], gb=f"{r['gb']:.2f}",
         step=r["step"], dtensor=r["dtensor"], device=r["device"], seconds=f"{out['restore_s']:.1f}")
    if out["dp"] != out["plain"] or len(out["dp"]) != DIST_STEPS:
        raise AssertionError("distributed: the data-parallel loop's losses are not the loop's bit for bit")
    if r["differ"] or not r["dtensor"] or r["device"] != "cuda" or r["step"] != DIST_STEPS:
        raise AssertionError("distributed: the sharded restore is not the checkpoint bit for bit")
    return out["launches"]


def phase_distributed(step_ms):
    """The distributed layer on the card, after phase train: (a) an NCCL
    group of world size 1 (in-process store) and the (1, 1) smoke mesh, and
    the rules at production size; (b) compression at full width; (c) four
    gloo ranks on CUDA tensors; (d) gpipe at one stage, the data-parallel
    loop and the sharded restore.  No kernel launches (gated)."""
    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.launch.mesh import init_process_group, make_smoke_mesh

    kernels.reset_launch_counts()
    if not init_process_group("cuda"):
        raise AssertionError("distributed: a process group was already open")
    try:
        mesh = make_smoke_mesh(1, 1, device="cuda")
        line("distributed", backend=dist.get_backend(), world_size=dist.get_world_size(),
             mesh=json.dumps(dict(zip(mesh.mesh_dim_names, mesh.shape))).replace(" ", ""),
             device_type=mesh.device_type, store="in-process")
        dist_rules()
        dist_compression(mesh, step_ms)
        dist_gloo_cuda()
        child = dist_rest(mesh)
    finally:
        dist.destroy_process_group()
    counts = kernels.launch_counts()
    import dataclasses

    from repro_torch.configs import get_config

    # the loop child's two runs of DIST_STEPS steps each, f32 moments
    want = optimizer_launches(dataclasses.replace(get_config(ARCH), n_layers=TRAIN_LAYERS), 2 * DIST_STEPS)
    line("distributed", launches=json.dumps(counts).replace(" ", ""),
         loop_child_launches=json.dumps(child).replace(" ", ""), expected=json.dumps(want).replace(" ", ""))
    if any(counts.values()) or child != want:
        raise AssertionError(f"distributed: kernels launched {counts} here and {child} in the loop's process, not "
                             f"none and {want}")
    torch.cuda.empty_cache()


# ------------------------------------------------------------ tensor-parallel
TP_RANKS = 2  # (data, model) = (1, 2): two gloo ranks on the one card (NCCL takes one rank a card)
TP_LAYERS = 2
TP_STEPS = 2
# (a): the data-parallel case's tolerances (tests/test_torch_distributed.py):
# f32, the splits sum partial products over model in another order than one
# device's single products
TP_LOSS_RTOL, TP_LOSS_ATOL = 1e-5, 1e-6
TP_GRAD_TOL = 1e-4  # atol = rtol, per entry
# (b): bf16; each model rank's partial product is rounded to bf16 before the
# f32 sum over model, a rounding one device does not make (the CPU smoke run
# reads 8e-5 apart); a quarter of one bf16 step (2^-8) still fails a partial
# dropped or counted twice (tests/test_torch_distributed.py, LAUNCH_RTOL)
TP_LAUNCH_RTOL = 1e-3


def _tp_split(cfg, model: int):
    """What each model rank computes of full-width ``cfg``: its heads, KV
    heads, SwiGLU hidden and vocabulary columns (uneven slices where
    ``model`` does not divide)."""
    from repro_torch.models.common import grouped_head_split, split_range

    G = cfg.n_heads // cfg.n_kv_heads
    by = grouped_head_split(cfg.n_kv_heads, G, model)
    parts = []
    for r in range(model):
        kv = split_range(cfg.n_kv_heads, model, r) if by == "kvh" else (0, cfg.n_kv_heads)
        g = (0, G) if by == "kvh" else split_range(G, model, r)
        f, v = split_range(cfg.d_ff, model, r), split_range(cfg.vocab_size, model, r)
        parts.append(f"{(kv[1] - kv[0]) * (g[1] - g[0])}q/{kv[1] - kv[0]}kv,{f[1] - f[0]},{v[1] - v[0]}")
    return by, ";".join(parts)


def _tp_grad_ms(grad_fn, params, batch):
    """(loss, parts, grads, ms): one call of ``grad_fn``, host clock,
    synchronised."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, parts, grads = grad_fn(params, batch)
    torch.cuda.synchronize()
    return loss, parts, grads, (time.perf_counter() - t0) * 1e3


def _tp_reference(root: str):
    """(a), one process: the loss and gradients of qwen3-14b at full width,
    TP_LAYERS layers, on an f32 copy of the seed's weights, the second of
    two calls timed; the gradients go to the host and a file for the ranks."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.training.loop import make_grad_fn

    cfg = dataclasses.replace(get_config(ARCH), n_layers=TP_LAYERS)
    params = f32_tree(api.init_params(cfg, SEED, "cuda"))
    batch, grad_fn = _train_batch(cfg, 0), make_grad_fn(cfg)
    grad_fn(params, batch)
    loss, parts, grads, ms = _tp_grad_ms(grad_fn, params, batch)
    torch.save({"loss": float(loss), "grads": [g.cpu() for g in grads]}, os.path.join(root, "ref.pt"))
    del params, grads
    torch.cuda.empty_cache()
    return float(loss), ms


def _tp_launch_one(root: str, result: str):
    """(b), in a fresh process: ``launch/train.main --full --layers
    TP_LAYERS --data 1 --model 1`` (one rank, NCCL at world size 1)."""
    from repro_torch import kernels
    from repro_torch.launch import train as launcher

    t0 = time.perf_counter()
    res = launcher.main(["--full", "--layers", str(TP_LAYERS), "--steps", str(TP_STEPS), "--ckpt-every",
                         str(TP_STEPS), "--ckpt-dir", os.path.join(root, "one"), "--data", "1", "--model", "1",
                         "--device", "cuda"])
    with open(result, "w") as f:
        json.dump({"losses": res["losses"], "s": time.perf_counter() - t0, "launches": kernels.launch_counts()}, f)


def _worst_leaf(params, grads, ref_grads):
    """(|g - want| - (atol + rtol |want|), max |g - want|, leaf) at the
    worst entry of the worst leaf, TP_GRAD_TOL as atol and rtol."""
    import torch

    per_leaf = []
    for (name, _), g, want in zip(_named_leaves(params), grads, ref_grads):
        want = want.to("cuda")
        gap = torch.sub(g, want).abs_()
        worst_gap = float(gap.max())
        per_leaf.append((float(gap.sub_(want.abs_().mul_(TP_GRAD_TOL).add_(TP_GRAD_TOL)).max()), worst_gap, name))
    return max(per_leaf)


def _tp_rank_grads(root: str, mesh):
    """(a) on one rank: the loss and gradients of ``_tp_reference``'s
    model through ``make_grad_fn`` under ``mesh``, the second of two calls
    timed, gated per leaf against the one-process file; then the gradient
    reduction over model timed alone."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import api
    from repro_torch.training.loop import make_grad_fn, reduce_grads

    cfg = dataclasses.replace(get_config(ARCH), n_layers=TP_LAYERS)
    params = f32_tree(api.init_params(cfg, SEED, "cuda"))
    batch, grad_fn, out = _train_batch(cfg, 0), make_grad_fn(cfg, mesh), {}
    torch.cuda.reset_peak_memory_stats()
    grad_fn(params, batch)
    loss, _, grads, out["step_ms"] = _tp_grad_ms(grad_fn, params, batch)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    ref = torch.load(os.path.join(root, "ref.pt"), mmap=True)
    out["loss"], out["loss_ref"] = float(loss), ref["loss"]
    out["worst_excess"], out["worst_gap"], out["worst_leaf"] = _worst_leaf(params, grads, ref["grads"])
    out["leaves"] = len(grads)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reduce_grads(mesh, shd.model_partial_leaves(api.param_specs(cfg)), grads)
    torch.cuda.synchronize()
    out["reduce_ms"] = (time.perf_counter() - t0) * 1e3
    return out


_COLLECTIVE_CALLS = {"all_reduce": ("all-reduce", 0), "all_gather_into_tensor": ("all-gather", 1),
                     "reduce_scatter_tensor": ("reduce-scatter", 1)}


@contextlib.contextmanager
def _counting_collectives():
    """``with _counting_collectives() as sent:`` the bytes this process hands
    ``dist.all_reduce``, ``dist.all_gather_into_tensor`` and
    ``dist.reduce_scatter_tensor``, by kind, in the dry run's convention
    (``launch/cost.py``: an all-reduce's buffer, the others' input; a
    group of one rank moves nothing)."""
    import torch.distributed as dist

    sent, originals = {}, {name: getattr(dist, name) for name in _COLLECTIVE_CALLS}

    def counted(name):
        kind, at = _COLLECTIVE_CALLS[name]

        def call(*args, **kwargs):
            if dist.get_world_size(kwargs.get("group")) > 1:
                sent[kind] = sent.get(kind, 0) + args[at].numel() * args[at].element_size()
            return originals[name](*args, **kwargs)

        return call

    for name in _COLLECTIVE_CALLS:
        setattr(dist, name, counted(name))
    try:
        yield sent
    finally:
        for name, fn in originals.items():
            setattr(dist, name, fn)


def _tp_seq_grads(root: str, mesh):
    """(c) on one rank: ``_tp_reference``'s model with remat and
    ``seq_shard`` on (the residual stream split over sequence between
    blocks) through ``make_grad_fn`` under ``mesh``, its collectives
    counted by kind and its peak memory read on the first of two calls and
    the second timed, gated per leaf against the one-process file as (a)
    is; then one call of the same step with ``seq_shard`` off (remat on):
    its collectives, peak memory and ms (a first call, so not warm)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.training.loop import make_grad_fn

    out = {}
    for on in (True, False):
        cfg = dataclasses.replace(get_config(ARCH), n_layers=TP_LAYERS, remat=True, seq_shard=on)
        params = f32_tree(api.init_params(cfg, SEED, "cuda"))
        batch, grad_fn = _train_batch(cfg, 0), make_grad_fn(cfg, mesh)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with _counting_collectives() as sent:
            loss, _, grads, ms = _tp_grad_ms(grad_fn, params, batch)
        key = "on" if on else "off"
        out[f"peak_mem_gb_{key}"] = torch.cuda.max_memory_allocated() / 1e9
        if on:  # the first call is counted and its peak read; the second, warm, is timed
            del grads
            loss, _, grads, ms = _tp_grad_ms(grad_fn, params, batch)
        out[f"step_ms_{key}"], out[f"collective_bytes_{key}"] = ms, sent
        if on:
            ref = torch.load(os.path.join(root, "ref.pt"), mmap=True)
            out["loss"], out["loss_ref"] = float(loss), ref["loss"]
            out["worst_excess"], out["worst_gap"], out["worst_leaf"] = _worst_leaf(params, grads, ref["grads"])
            out["leaves"] = len(grads)
        del params, grads
    torch.cuda.empty_cache()
    return out


def _tp_rank(rank: int, store: str, root: str):
    """One of TP_RANKS gloo ranks on the one card, at (data, model) = (1,
    TP_RANKS): (a) ``_tp_rank_grads``; (c) ``_tp_seq_grads``; (b)
    ``launch/train.main --full --layers TP_LAYERS --data 1 --model
    TP_RANKS``.  Writes its results, its kernel launch counts among them,
    to ``root/rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.launch import train as launcher
    from repro_torch.launch.mesh import make_smoke_mesh

    # the two ranks and this script's process share the card, and at (b)'s
    # optimizer step the ranks' f32 temporaries of the 1.56 GB embedding
    # leave it within 2.4 GB of full: segments that grow in place keep
    # each rank's reserved-but-unallocated slack (3.4 GB seen) from
    # tipping it over.  Set before this process's first CUDA call.
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=TP_RANKS)
    try:
        out = _tp_rank_grads(root, make_smoke_mesh(1, TP_RANKS, device="cuda"))
        line("tensor-parallel", part="a", rank=rank, loss=f"{out['loss']:.7f}",
             loss_one_process=f"{out['loss_ref']:.7f}", leaves=out["leaves"], worst_leaf=out["worst_leaf"],
             worst_abs_gap=f"{out['worst_gap']:.3e}", worst_excess_over_tol=f"{out['worst_excess']:.3e}",
             step_ms=f"{out['step_ms']:.1f}", grad_reduce_ms=f"{out['reduce_ms']:.1f}",
             peak_mem_gb=f"{out['peak_mem_gb']:.2f}",
             gates=f"loss_rtol{TP_LOSS_RTOL}_atol{TP_LOSS_ATOL},grads_atol=rtol{TP_GRAD_TOL}")
        torch.cuda.empty_cache()
        seq = out["seq"] = _tp_seq_grads(root, make_smoke_mesh(1, TP_RANKS, device="cuda"))
        line("tensor-parallel", part="c", rank=rank, seq_shard=True, remat=True, loss=f"{seq['loss']:.7f}",
             loss_one_process=f"{seq['loss_ref']:.7f}", leaves=seq["leaves"], worst_leaf=seq["worst_leaf"],
             worst_abs_gap=f"{seq['worst_gap']:.3e}", worst_excess_over_tol=f"{seq['worst_excess']:.3e}",
             step_ms=f"{seq['step_ms_on']:.1f}", first_call_ms_seq_shard_off=f"{seq['step_ms_off']:.1f}",
             collective_bytes=json.dumps(seq["collective_bytes_on"]).replace(" ", ""),
             collective_bytes_seq_shard_off=json.dumps(seq["collective_bytes_off"]).replace(" ", ""),
             peak_mem_gb=f"{seq['peak_mem_gb_on']:.3f}", peak_mem_gb_seq_shard_off=f"{seq['peak_mem_gb_off']:.3f}",
             gates=f"loss_rtol{TP_LOSS_RTOL}_atol{TP_LOSS_ATOL},grads_atol=rtol{TP_GRAD_TOL}")
        t0 = time.perf_counter()
        res = launcher.main(["--full", "--layers", str(TP_LAYERS), "--steps", str(TP_STEPS), "--ckpt-every",
                             str(TP_STEPS), "--ckpt-dir", os.path.join(root, "tp"), "--data", "1", "--model",
                             str(TP_RANKS), "--device", "cuda"])
        out["launch_losses"], out["launch_s"] = res["losses"], time.perf_counter() - t0
        out["launches"] = kernels.launch_counts()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def phase_tensor_parallel():
    """Tensor parallelism over ``model`` on the card: (a) full-width
    qwen3-14b, TP_LAYERS of 40 layers, f32: one process's loss and
    gradients, then TP_RANKS spawned gloo ranks at (1, TP_RANKS) on CUDA
    tensors, each gated against them leaf by leaf; (c) on the same ranks,
    the same model with remat and ``seq_shard`` on (the residual stream
    split over sequence), gated against the same file, with its
    collective bytes by kind and its peak memory beside the same step
    with ``seq_shard`` off, and ``lower_cell``'s prediction for the step
    at (1, TP_RANKS) (bf16, AdamW: the train step it traces); (b)
    ``launch/train.main --model TP_RANKS`` in bf16 against ``--model 1``.
    No kernel launches, in this process or on any rank (gated).  Step
    times are over gloo through host memory (NCCL takes one rank a card),
    so they say nothing of NVLink."""
    import dataclasses
    import multiprocessing
    import tempfile

    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config

    kernels.reset_launch_counts()
    cfg = dataclasses.replace(get_config(ARCH), n_layers=TP_LAYERS)
    by, split = _tp_split(cfg, TP_RANKS)
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tp_") as root:
        loss1, ms1 = _tp_reference(root)
        line("tensor-parallel", part="a", arch=cfg.name, layers=f"{TP_LAYERS}_of_40", dtype="float32",
             mesh=f"data1_model{TP_RANKS}", backend="gloo", tensors="cuda", split_by=by,
             per_rank_heads_hidden_vocab=split, batch=f"{TRAIN_BATCH}x{TRAIN_SEQ}",
             one_process_step_ms=f"{ms1:.1f}", one_process_loss=f"{loss1:.7f}",
             note="step=forward+backward+gradient_reduction;ranks_over_gloo_through_host_memory_not_NVLink")
        one = os.path.join(root, "one.json")
        p = ctx.Process(target=_tp_launch_one, args=(root, one))
        p.start()
        _join([p], 600, "the --model 1 launcher run")
        with open(one) as f:
            one = json.load(f)
        shutil.rmtree(os.path.join(root, "one"), ignore_errors=True)
        procs = [ctx.Process(target=_tp_rank, args=(r, os.path.join(root, "store"), root)) for r in range(TP_RANKS)]
        for p in procs:
            p.start()
        _join(procs, 900, "the tensor-parallel ranks")
        outs = []
        for r in range(TP_RANKS):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                outs.append(json.load(f))
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import AbstractMesh
    from repro_torch.launch import steps

    lowered = steps.lower_cell(AbstractMesh((1, TP_RANKS), ("data", "model")), cfg,
                               ShapeConfig("tp_train", TRAIN_SEQ, TRAIN_BATCH, "train"))
    mem = lowered.memory_analysis()
    line("tensor-parallel", part="c", what="lower_cell_prediction_bf16_AdamW_step", mesh=f"data1_model{TP_RANKS}",
         seq_shard=lowered.seq_shard, temp_gb=f"{mem['temp_size_in_bytes'] / 1e9:.3f}",
         peak_gb=f"{mem['peak_bytes_per_device'] / 1e9:.3f}", held_peak_gb=f"{mem['held_peak_bytes'] / 1e9:.3f}",
         collective_bytes=json.dumps({a: dict(k) for a, k in lowered.totals.coll_bytes_by_axis_op.items()})
         .replace(" ", ""), measured_peak_gb_f32_grads=f"{outs[0]['seq']['peak_mem_gb_on']:.3f}",
         note="counts_on_meta_not_a_chip_measurement")
    losses = outs[0]["launch_losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, one["losses"]))
    line("tensor-parallel", part="b", check=f"launch/train.main --full --layers {TP_LAYERS} --data 1 --model "
         f"{TP_RANKS} vs --model 1, bf16, {TP_STEPS} steps", losses_model2=",".join(f"{x:.6f}" for x in losses),
         losses_model1=",".join(f"{x:.6f}" for x in one["losses"]), max_rel_gap=f"{rel:.3e}", rtol=TP_LAUNCH_RTOL,
         model2_s=f"{outs[0]['launch_s']:.1f}", model1_s=f"{one['s']:.1f}")
    counts = kernels.launch_counts()
    # each rank's and the --model 1 run's launcher steps (f32 moments); the
    # gradient checks (a) and (c) run no optimizer
    want = optimizer_launches(cfg, TP_STEPS)
    line("tensor-parallel", launches=json.dumps(counts).replace(" ", ""),
         rank_launches=json.dumps([o["launches"] for o in outs]).replace(" ", ""),
         model1_launches=json.dumps(one["launches"]).replace(" ", ""), expected=json.dumps(want).replace(" ", ""),
         seconds=f"{time.perf_counter() - t0:.1f}")
    torch.cuda.empty_cache()
    for r, o in enumerate(outs):
        for part, res in (("a", o), ("c", o["seq"])):
            if abs(res["loss"] - res["loss_ref"]) > TP_LOSS_ATOL + TP_LOSS_RTOL * abs(res["loss_ref"]):
                raise AssertionError(f"tensor-parallel ({part}): rank {r}'s loss {res['loss']} is not one process's "
                                     f"{res['loss_ref']}")
            if res["worst_excess"] > 0:
                raise AssertionError(f"tensor-parallel ({part}): rank {r}'s gradient of {res['worst_leaf']} is "
                                     f"{res['worst_gap']:.3e} from one process's (atol = rtol {TP_GRAD_TOL})")
        if set(o["seq"]["collective_bytes_on"]) != {"all-reduce", "all-gather", "reduce-scatter"}:
            raise AssertionError(f"tensor-parallel (c): rank {r} sent {o['seq']['collective_bytes_on']}: the split "
                                 "stream all-gathers and reduce-scatters over model")
        if o["launch_losses"] != losses or o["launches"] != want:
            raise AssertionError(f"tensor-parallel: rank {r}'s launcher losses or launch counts differ: {o}")
    if len(losses) != TP_STEPS or rel > TP_LAUNCH_RTOL or any(counts.values()) or one["launches"] != want:
        raise AssertionError(f"tensor-parallel: --model {TP_RANKS} losses {losses} against --model 1 "
                             f"{one['losses']} (rtol {TP_LAUNCH_RTOL}), launches {counts} here and "
                             f"{one['launches']} in the --model 1 run, not none and {want}")


# -------------------------------------------------------------------- dry run
DRYRUN_PROMPT, DRYRUN_DECODED = 128, 8  # the serve path's prompt and greedy tokens
# decode's counted bytes against the bytes a decode step must read: the
# plain versions read the whole page-rounded cache, in f32 copies, and the
# activations' ops move little at B 1
DRYRUN_DECODE_BYTES = (1.0, 1.25)
DRYRUN_FLOP_RTOL = 0.01  # the counter's matmul FLOPs against torch.profiler's with_flops total
DRYRUN_PROFILE_LAYERS = 4  # the eager prefill held against torch.profiler: full width, 4 of 40 layers
DRYRUN_CELLS = (("qwen3-14b", "train_4k"), ("glm4-9b", "decode_32k"))  # on (16, 16), in subprocesses
# qwen3-14b x train_4k on (16, 16) as the dry run counted it while the
# residual stream stayed whole on every model rank: per card, temporaries
# and peak, and the all-reduce bytes over model (counts, not measurements)
DRYRUN_WHOLE_STREAM = {"temp_gb": 79.45, "peak_gb": 80.03, "model_all_reduce_gb": 325.7}
# the same cell's temp and peak while AdamW ran as ~25 eager ops a leaf, with
# f32 temporaries beside every whole gradient, and the op that set the peak
DRYRUN_EAGER_ADAMW = {"temp_gb": 79.45, "peak_gb": 80.03, "peak_at_op": "aten.div,op_29963_of_30142"}


def _terms(lowered, cfg, shape):
    """Roofline terms of a lowered cell in ms, and its counts."""
    from repro_torch.launch.roofline import extract

    rl, _ = extract(lowered, cfg, shape, 1)
    return {"flops": rl.flops, "bytes": rl.hbm_bytes, "compute_ms": rl.compute_s * 1e3,
            "memory_ms": rl.memory_s * 1e3, "collective_ms": rl.collective_s * 1e3, "bottleneck": rl.bottleneck}


def _saved_bytes_whole_stream(arch: str, shape: str) -> int:
    """What remat keeps from the forward of ``arch`` x ``shape``'s train
    step on the (16, 16) mesh with ``seq_shard`` off (every model rank
    holding the whole residual stream): the cost counter's saved bytes
    for the forward and backward, traced on meta as ``lower_cell``
    traces the step."""
    import dataclasses

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import cost
    from repro_torch.launch.mesh import CARDS_PER_HOST, fake_mesh, production_mesh_shape
    from repro_torch.models import api
    from repro_torch.training.loop import make_grad_fn

    cfg = dataclasses.replace(get_config(arch), remat=True, seq_shard=False)
    with fake_mesh(production_mesh_shape()) as dm:
        with cost.CostCounter(cost.axes_of(dm), CARDS_PER_HOST) as counter:
            make_grad_fn(cfg, dm)(api.param_specs(cfg), api.input_specs(cfg, SHAPES[shape]))
    return counter.totals.saved_bytes


def _dryrun_line(part, what, terms, measured_ms, measured_from, **kv):
    line("dryrun", part=part, what=what.replace(" ", "_"), flops=f"{terms['flops']:.4e}",
         bytes=f"{terms['bytes']:.4e}", compute_ms=f"{terms['compute_ms']:.3f}",
         memory_ms=f"{terms['memory_ms']:.3f}", collective_ms=f"{terms['collective_ms']:.3f}",
         bottleneck=terms["bottleneck"], measured_ms=f"{measured_ms:.3f}", measured_from=measured_from,
         compute_share=f"{terms['compute_ms'] / measured_ms:.4f}",
         memory_share=f"{terms['memory_ms'] / measured_ms:.4f}", **kv)


def _profiler_flops_check():
    """One eager plain-path prefill of full-width qwen3-14b
    (DRYRUN_PROFILE_LAYERS layers, B 1, DRYRUN_PROMPT tokens) on the card,
    counted by the cost counter and by torch.profiler (with_flops): the
    counter's matmul FLOPs against the profiler's total."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import cost
    from repro_torch.models import api

    cfg = dataclasses.replace(get_config(ARCH), n_layers=DRYRUN_PROFILE_LAYERS)
    params = api.init_params(cfg, SEED, "cuda")
    toks = torch.arange(DRYRUN_PROMPT, device="cuda")[None] % cfg.vocab_size
    prefill = api.prefill_fn(cfg, plain_kernels=True)

    def run():
        with torch.inference_mode():
            return prefill(params, {"tokens": toks}, api.init_cache(cfg, 1, DRYRUN_PROMPT, "cuda"), 0)

    run()
    _, counted = cost.count(run)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA], with_flops=True) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    total = sum(e.flops for e in events)
    matmul = sum(e.flops for e in events if e.key in ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm"))
    gap = abs(counted.matmul_flops - total) / total if total else float("inf")
    line("dryrun", part="profiler", what=f"eager plain prefill, {cfg.name} at full width, "
         f"{DRYRUN_PROFILE_LAYERS} of 40 layers, B1 S{DRYRUN_PROMPT}".replace(" ", "_"),
         counter_matmul_flops=f"{counted.matmul_flops:.6e}", counter_flops=f"{counted.flops:.6e}",
         profiler_flops=f"{total:.6e}", profiler_matmul_flops=f"{matmul:.6e}", rel_gap=f"{gap:.3e}",
         rtol=DRYRUN_FLOP_RTOL)
    del params
    torch.cuda.empty_cache()
    if gap > DRYRUN_FLOP_RTOL:
        raise AssertionError(f"dryrun: the counter's matmul FLOPs {counted.matmul_flops:.6e} are {gap:.3e} from "
                             f"torch.profiler's {total:.6e} (rtol {DRYRUN_FLOP_RTOL})")


def phase_dryrun(train_step_ms: float, serve_times, cells=()):
    """The dry run (``launch.steps.lower_cell``: the step traced on meta
    tensors in this process, no device) beside what the card measured in
    this run: (a) qwen3-14b's serve-shape prefill (B 1, S 128) and decode
    (B 1, kv 136) at full width at mesh (1, 1), each roofline term's share
    of phase serve's graph device ms; (b) the train cell, 8 of 40 layers,
    B 8 x S 128, against phase train's step ms; the counter against
    torch.profiler on one eager prefill on the card; (c) two full-width
    production cells on (16, 16) through ``launch.dryrun`` in
    subprocesses; (d) each of ``cells`` (``phase_full_cell``'s records)
    at the same serve shapes as (a), its predicted peak bytes beside the
    peak its phase measured and the card's memory (a prediction over the
    card is printed, not gated).  Gates: decode's bytes within DRYRUN_DECODE_BYTES of
    what a decode step must read (every parameter but the embedding
    table, whose rows it gathers, and the K/V of the 136 cached tokens);
    the counter within DRYRUN_FLOP_RTOL of the profiler; each production
    cell ok with FLOPs and bytes above 0."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import AbstractMesh
    from repro_torch.launch import steps
    from repro_torch.launch.cost import nbytes
    from repro_torch.models import api
    from repro_torch.models.common import tree_flatten

    t0 = time.perf_counter()
    one = AbstractMesh((1, 1), ("data", "model"))
    cfg = get_config(ARCH)
    timing = serve_times
    kv = DRYRUN_PROMPT + DRYRUN_DECODED
    prefill = ShapeConfig("serve_prefill", DRYRUN_PROMPT, 1, "prefill")
    decode = ShapeConfig("serve_decode", kv, 1, "decode")
    pre = steps.lower_cell(one, cfg, prefill)
    dec = steps.lower_cell(one, cfg, decode)
    pre_t, dec_t = _terms(pre, cfg, prefill), _terms(dec, cfg, decode)
    specs = api.param_specs(cfg)
    weights = sum(nbytes(t) for t in tree_flatten(specs)[0])
    kv_bytes = 2 * cfg.n_layers * kv * cfg.n_kv_heads * cfg.d_head * 2
    must_read = weights - nbytes(specs["embed"]) + kv_bytes
    ratio = dec_t["bytes"] / must_read
    _dryrun_line("a", f"{cfg.name} prefill B1 S{DRYRUN_PROMPT} at mesh (1,1)", pre_t,
                 timing["graph_prefill_device_ms"], "phase_serve_graph_prefill_device_ms",
                 trace_s=f"{pre.lower_s:.2f}", matmul_flops=f"{pre.totals.matmul_flops:.4e}")
    _dryrun_line("a", f"{cfg.name} decode B1 kv{kv} at mesh (1,1)", dec_t,
                 timing["graph_decode_device_ms_per_token"], "phase_serve_graph_decode_device_ms_per_token",
                 trace_s=f"{dec.lower_s:.2f}", must_read_bytes=f"{must_read:.4e}", bytes_over_must_read=f"{ratio:.4f}",
                 gate=f"{DRYRUN_DECODE_BYTES[0]}..{DRYRUN_DECODE_BYTES[1]}", weights_gb=f"{weights / 1e9:.2f}",
                 embed_gb=f"{nbytes(specs['embed']) / 1e9:.2f}")

    train_cfg = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)
    train = ShapeConfig("train_cell", TRAIN_SEQ, TRAIN_BATCH, "train")
    tr = steps.lower_cell(one, train_cfg, train)
    _dryrun_line("b", f"{train_cfg.name} train {TRAIN_LAYERS} of 40 layers B{TRAIN_BATCH} S{TRAIN_SEQ} at mesh (1,1), "
                 "remat and AdamW as lower_cell builds them", _terms(tr, train_cfg, train), train_step_ms,
                 "phase_train_median_step_ms", trace_s=f"{tr.lower_s:.2f}",
                 peak_bytes_per_device=tr.memory_analysis()["peak_bytes_per_device"],
                 note="phase_train_runs_remat_off")
    _profiler_flops_check()

    failed = []
    for arch, shape in DRYRUN_CELLS:
        out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
                              "--pods", "1"], capture_output=True, text=True, timeout=600,
                             env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src")), cwd=HERE)
        print(out.stdout, end="", flush=True)
        from repro_torch.launch.dryrun import cell_path

        rec = {}
        if out.returncode == 0 and os.path.exists(cell_path(arch, shape, 1)):
            with open(cell_path(arch, shape, 1)) as f:
                rec = json.load(f)
        line("dryrun", part="c", cell=f"{arch}x{shape}x1pod", record=json.dumps(rec).replace(" ", ""))
        if rec.get("ok") and shape.startswith("train"):
            mem = rec["memory_analysis"]
            model = rec["collectives"]["bytes_by_axis_op"].get("model", {})
            line("dryrun", part="c", cell=f"{arch}x{shape}x1pod", seq_shard=rec["seq_shard"],
                 temp_gb=f"{mem['temp_size_in_bytes'] / 1e9:.2f}", peak_gb=f"{mem['peak_bytes_per_device'] / 1e9:.2f}",
                 peak_at_op=mem["peak_at_op"].replace(" ", "_"),
                 saved_for_backward_gb=f"{mem['saved_for_backward_bytes'] / 1e9:.3f}",
                 saved_for_backward_gb_seq_shard_off=f"{_saved_bytes_whole_stream(arch, shape) / 1e9:.3f}",
                 model_axis_gb=json.dumps({k: round(v / 1e9, 2) for k, v in model.items()}).replace(" ", ""),
                 whole_stream=json.dumps(DRYRUN_WHOLE_STREAM).replace(" ", ""),
                 eager_adamw=json.dumps(DRYRUN_EAGER_ADAMW).replace(" ", ""),
                 note="dry_run_counts_on_meta_not_chip_measurements")
        cost_ = rec.get("cost_analysis", {})
        if not (rec.get("ok") and cost_.get("flops", 0) > 0 and cost_.get("bytes_accessed", 0) > 0):
            failed.append(f"{arch} x {shape}: rc {out.returncode}, {out.stderr[-1500:]}")
    import torch

    card = torch.cuda.get_device_properties(0).total_memory
    for cell in cells:
        ccfg = cell["cfg"]
        for shape in (prefill, decode):
            lowered = steps.lower_cell(one, ccfg, shape)
            mem = lowered.memory_analysis()
            terms = _terms(lowered, ccfg, shape)
            measured = (cell["timing"]["graph_prefill_device_ms"] if shape.kind == "prefill"
                        else cell["timing"]["graph_decode_device_ms_per_token"])
            _dryrun_line("d", f"{cell['phase']} {shape.kind} B1 {'S' if shape.kind == 'prefill' else 'kv'}"
                         f"{shape.seq_len} at mesh (1,1), {ccfg.n_layers} layers", terms, measured,
                         f"phase_{cell['phase']}_graph_{shape.kind}_device_ms", trace_s=f"{lowered.lower_s:.2f}",
                         argument_gb=f"{mem['argument_size_in_bytes'] / 1e9:.3f}",
                         temp_gb=f"{mem['temp_size_in_bytes'] / 1e9:.3f}",
                         predicted_peak_gb=f"{mem['peak_bytes_per_device'] / 1e9:.3f}",
                         measured_phase_peak_gb=f"{cell['peak_bytes'] / 1e9:.3f}", card_gb=f"{card / 1e9:.3f}",
                         prediction_over_card=mem["peak_bytes_per_device"] > card)
    line("dryrun", seconds=f"{time.perf_counter() - t0:.1f}")
    if not DRYRUN_DECODE_BYTES[0] <= ratio <= DRYRUN_DECODE_BYTES[1]:
        failed.append(f"decode bytes {dec_t['bytes']:.4e} are {ratio:.4f}x the {must_read:.4e} a step must read")
    if failed:
        raise AssertionError("dryrun: " + "; ".join(failed))


def phase_kernels_micro():
    """``launch/micro.py`` on the card: each kernel at the reference's
    micro shapes, its bytes by design and its plain version's (the cost
    counter on meta), its bound and its time (CUDA-graph replay, median of
    5).  These launches are after the main paths' counts were read.  Gate:
    every kernel timed, finite and above 0."""
    import math

    from repro_torch.launch import micro

    t0 = time.perf_counter()
    recs = micro.run("cuda", seed=SEED, verbose=False)
    for r in recs:
        line("kernels-micro", name=r["name"], shape=r["shape"].replace(" ", "_"), dtype=r["dtype"],
             kernel_bytes=f"{r['kernel_hbm_bytes']:.4e}", oracle_bytes=f"{r['oracle_hbm_bytes']:.4e}",
             traffic_reduction=f"{r['traffic_reduction']:.1f}", bound_ms=f"{r['bound_ms']:.5f}",
             bound_by=r["bound_by"], kernel_ms=f"{r['kernel_ms']:.5f}", share_of_bound=f"{r['share_of_bound']:.3f}",
             library_ms="null" if r["library_ms"] is None else f"{r['library_ms']:.5f}")
    line("kernels-micro", seconds=f"{time.perf_counter() - t0:.1f}")
    bad = [r["name"] for r in recs if not (math.isfinite(r["kernel_ms"]) and r["kernel_ms"] > 0)]
    if bad:
        raise AssertionError(f"kernels-micro: no time for {bad}")


def kernels_line(recs, counts, replayed, by_path=None):
    """``recs`` maps each kernel to its record; ``counts`` to the launch
    counts of the main paths that run it: the serve paths for flash and
    paged_decode (qwen3-14b over the sharded store and over the cluster,
    qwen2.5-32b, chameleon-34b and kimi-k2, each counted from 0 just
    before it), the codec's entry points over the
    serve blocks and the latent slab for quantize and dequantize,
    rwkv6-1.6b for wkv, zamba2-1.2b for ssd, phase train's main path for
    the fused AdamW's sq_norm, adamw_update and factored_stats.  ``replayed`` maps each
    kernel to the launches the same paths' CUDA-graph replays ran, read
    from device traces; ``by_path`` to each path's share of both."""
    entries = []
    for name, src, rep, tol in (
        ("flash", "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention/flash_attention.py:61", BF16_LIMIT),
        ("paged_decode", "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
         "src/repro/kernels/decode_attention/decode_attention.py:65", BF16_LIMIT),
        ("quantize", "src/repro_torch/kernels/kv_codec/csrc/kv_codec.cu",
         "src/repro/kernels/kv_codec/kv_codec.py:36", f"|dq|<={CODEC_Q_STEP},scale_rtol{CODEC_SCALE_RTOL}"),
        ("dequantize", "src/repro_torch/kernels/kv_codec/csrc/kv_codec.cu",
         "src/repro/kernels/kv_codec/kv_codec.py:57", "max(scale)+1e-3"),
        ("wkv", "src/repro_torch/kernels/rwkv6/csrc/rwkv6.cu",
         "src/repro/kernels/rwkv6/rwkv6.py:84", f"atol=rtol={WKV_TOL}"),
        ("ssd", "src/repro_torch/kernels/mamba2/csrc/mamba2.cu",
         "src/repro/kernels/mamba2/mamba2.py:70", f"atol=rtol={SSD_TOL}"),
        ("sq_norm", ADAMW_SOURCE, "src/repro/training/optim.py:99", f"rtol{ADAMW_NORM_RTOL}"),
        ("adamw_update", ADAMW_SOURCE, "src/repro/training/optim.py:109",
         f"state_rtol{OPT_STATE_RTOL},p_and_m_within_one_bf16_step"),
        ("factored_stats", ADAMW_SOURCE, "src/repro/training/optim.py:117", f"rtol{OPT_STATE_RTOL}"),
    ):
        rec = recs[name]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": counts[name], "replayed_launches": replayed[name],
            "launches_from": "the wrapper's counter over the main path's run: eager launches, and launches "
                             "recorded into CUDA graphs at capture (a replay runs no wrapper)",
            "replayed_launches_from": "torch.profiler trace of one replay of each captured step of the main "
                                      "path, times that step's replays on the path",
            "max_abs_err": rec["max_abs_err"], "tol": tol,
            "ms": rec["ms"], "kernel_ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "library_ms": rec.get("library_ms"),
        }
        for extra in ("large", "shape", "library", "paths"):
            if extra in rec:
                entry[extra] = rec[extra]
        if name in ADAMW_KERNELS:
            entry["replaces_note"] = ("no pallas_call: the reference's AdamW is plain jnp that XLA fuses inside its "
                                      "jitted train step")
            entry["launches_from"] = ("the wrappers' counter over phase train's main path (a): eager steps, the "
                                      "captured step's warm calls and its capture")
            entry["replayed_launches_from"] = ("torch.profiler trace of one replay of the captured train step, times "
                                               "its replays")
        if by_path and name in by_path:
            entry["by_path"] = by_path[name]
        for extra in ("olmoe", "minicpm3", "zamba2", "glm4", "chameleon", "kimi", "slab", "large_minicpm3",
                      "large_zamba2", "large_kimi", "large_one", "large_one_kimi", "whisper_encoder",
                      "whisper_cross"):
            if extra in rec:
                entry[extra] = rec[extra]
        if entry["library_ms"] is None:
            entry["library_note"] = {"quantize": "no single PyTorch call computes the absmax and the quantize together",
                                     "factored_stats": "no single PyTorch call computes the row and column means "
                                                       "of g^2 and folds them into vr and vc"
                                     }.get(name, "no single PyTorch call computes this scan")
        entries.append(entry)
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
    wkv = phase_wkv()
    ssd = phase_ssd()
    cfg, params, res, counts = phase_serve(SEED)
    serve_replayed, serve_times = phase_decode_check(cfg, params, res)
    cluster_counts, cluster_replayed = phase_cluster(cfg, params, res["stages"])
    # the KV blocks one 128-token prefill hands to the store, for the codec
    serve_blocks, _ = res["hook"](res["prompt"], 0)
    del params, res  # the steps hold the weights
    torch.cuda.empty_cache()
    glm_cfg, glm_params, glm_res, _ = phase_serve(SEED, "glm4-9b", phase="glm4")
    phase_decode_check(glm_cfg, glm_params, glm_res, phase="glm4-check", table="profile_prefill_glm4.txt")
    del glm_params, glm_res
    torch.cuda.empty_cache()
    cells = [phase_full_cell(phase, arch, n_layers) for phase, arch, n_layers in FULL_CELLS]
    rwkv6_counts, rwkv6_replayed, _ = phase_model("rwkv6", SEED)
    zamba2_counts, zamba2_replayed, _ = phase_model("zamba2", SEED)
    phase_model("olmoe", SEED)
    _, _, slab = phase_model("minicpm3", SEED, capture=latent_slab)
    phase_model("whisper", SEED)
    quant, dequant, codec_counts = phase_kv_codec(serve_blocks, slab)
    adamw_recs = phase_adamw()
    step_ms, train_graph, train_counts = phase_train()
    phase_distributed(step_ms)
    phase_tensor_parallel()
    phase_dryrun(step_ms, serve_times, cells)
    phase_kernels_micro()
    # the serve paths' attention launches: qwen3-14b's, then the full cells'
    serve_paths = ([("qwen3-14b", counts, serve_replayed), ("cluster", cluster_counts, cluster_replayed)]
                   + [(c["phase"], c["counts"], c["replayed"]) for c in cells])
    by_path = {k: {p: {"launches": c[k], "replayed_launches": r[k]} for p, c, r in serve_paths}
               for k in ("flash", "paged_decode")}
    path_counts = {"flash": sum(c["flash"] for _, c, _ in serve_paths),
                   "paged_decode": sum(c["paged_decode"] for _, c, _ in serve_paths),
                   "quantize": codec_counts["quantize"], "dequantize": codec_counts["dequantize"],
                   "wkv": rwkv6_counts["wkv"], "ssd": zamba2_counts["ssd"]}
    replayed = {"flash": sum(r["flash"] for _, _, r in serve_paths),
                "paged_decode": sum(r["paged_decode"] for _, _, r in serve_paths),
                "quantize": 0, "dequantize": 0,  # the codec's entry points run eagerly
                "wkv": rwkv6_replayed["wkv"], "ssd": zamba2_replayed["ssd"]}
    # the fused AdamW's: phase train's main path
    path_counts.update({k: train_counts[k] for k in ADAMW_KERNELS})
    replayed.update({k: train_graph["per_replay"].get(k, 0) * train_graph["replays"] for k in ADAMW_KERNELS})
    recs = {"flash": flash, "paged_decode": decode, "quantize": quant, "dequantize": dequant, "wkv": wkv, "ssd": ssd,
            **adamw_recs}
    print(json.dumps(kernels_line(recs, path_counts, replayed, by_path)), flush=True)
    print(f"total_s={time.perf_counter() - t_start:.1f} card={smi}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
