#!/usr/bin/env python3
"""Hold the paged decode kernel of two checkouts against each other on one
card: outputs bit for bit, and times in turns.

    python3 scripts/decode_ab.py --trees OLD NEW [--pairs 10]

Each tree is a directory holding a checkout's ``src/`` (for the parent
commit: ``git archive HEAD | tar -x -C DIR``).  Each is run in a process of
its own, ``--pairs`` times, in turns A B, B A, A B, ... (the order reversed
every round for more trees), so a drift of the card's clock lands on every
side.  The process builds that tree's
decode_attention library and runs ``paged_decode`` on the same seeded
contiguous pages at chip_smoke.py's phase paged_decode shapes (bf16 and
f32): qwen3-14b's serve decode (B 1, H 40, KVH 8, D 128, kv_len 136),
glm4-9b's (H 32, KVH 2), kimi-k2's (H 64, KVH 8, D 112), and 32 sequences
of kv_len up to 4096 over shuffled tables; then times each (CUDA-graph
replay, ``launch.micro.graph_ms``, median of 5).  Prints the card, whether
every tree's outputs equal the first's bit for bit, one line per run, and
per tree and case in ms: the median over its runs, its range (min..max),
and against the first tree the ratio of the medians, the median and range
of the round-by-round ratios, and whether the median lies inside the first
tree's range.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

CHILD = r"""
import json, sys
sys.path.insert(0, "src")
import torch
from repro_torch.kernels.decode_attention import paged_decode
from repro_torch.launch.micro import graph_ms

CASES = [  # name, B, H, KVH, D, page, NB, lens
    ("serve", 1, 40, 8, 128, 16, 9, [136]),
    ("glm4", 1, 32, 2, 128, 16, 9, [136]),
    ("kimi", 1, 64, 8, 112, 16, 9, [136]),
    ("large", 32, 40, 8, 128, 16, 256, None),
]
outs, times = {}, {}
for dtype in (torch.bfloat16, torch.float32):
    for name, B, H, KVH, D, page, NB, lens in CASES:
        g = torch.Generator(device="cuda").manual_seed(B * 1000 + H + D)
        P = B * NB + 3
        q = torch.randn((B, H, D), generator=g, device="cuda").to(dtype)
        kp = torch.randn((P, page, KVH, D), generator=g, device="cuda").to(dtype)
        vp = torch.randn((P, page, KVH, D), generator=g, device="cuda").to(dtype)
        tables = torch.randperm(P, generator=g, device="cuda")[:B * NB].to(torch.int32).view(B, NB).contiguous()
        if lens is None:
            kv_len = torch.randint(1, NB * page + 1, (B,), generator=g, device="cuda", dtype=torch.int32)
        else:
            kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
        key = f"{name}_{str(dtype).split('.')[-1]}"
        outs[key] = paged_decode(q, kp, vp, tables, kv_len).cpu()
        times[key] = graph_ms(lambda: paged_decode(q, kp, vp, tables, kv_len))
torch.save(outs, sys.argv[1])
print("RESULT " + json.dumps(times), flush=True)
"""


def run(tree: str, out: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, out], cwd=tree, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree} failed (exit {proc.returncode}):\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", required=True, help="checkout directories, the first the baseline")
    ap.add_argument("--pairs", type=int, default=10, help="rounds: each tree runs once a round")
    args = ap.parse_args()
    trees = [os.path.abspath(t) for t in args.trees]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card={smi}", flush=True)
    results, outputs = {t: [] for t in trees}, {}
    with tempfile.TemporaryDirectory(prefix="decode_ab_") as d:
        order = [t for i in range(args.pairs) for t in (trees if i % 2 == 0 else trees[::-1])]
        for i, t in enumerate(order):
            path = os.path.join(d, f"run{i}.pt")
            res = run(t, path)
            results[t].append(res)
            outputs.setdefault(t, torch.load(path))
            print(f"run tree={t} " + " ".join(f"{k}={v:.5f}" for k, v in res.items()), flush=True)
    base = outputs[trees[0]]
    equal = {t: all(torch.equal(outputs[t][k], base[k]) for k in base) for t in trees}
    print("outputs_bit_for_bit_as_first_tree " + json.dumps(equal), flush=True)
    cases = list(results[trees[0]][0])
    base_runs = results[trees[0]]
    med0 = {c: statistics.median(r[c] for r in base_runs) for c in cases}
    for t in trees:
        runs = results[t]
        for c in cases:
            vals = [r[c] for r in runs]
            med = statistics.median(vals)
            ratios = [r[c] / b[c] for r, b in zip(runs, base_runs)]  # round by round
            lo0, hi0 = min(b[c] for b in base_runs), max(b[c] for b in base_runs)
            print(f"case tree={t} case={c} runs={len(vals)} median_ms={med:.5f} range_ms={min(vals):.5f}.."
                  f"{max(vals):.5f} median_ratio={med / med0[c]:.4f} round_ratio_median="
                  f"{statistics.median(ratios):.4f} round_ratio_range={min(ratios):.4f}..{max(ratios):.4f} "
                  f"median_inside_first_tree_range={lo0 <= med <= hi0}", flush=True)
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
