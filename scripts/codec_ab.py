#!/usr/bin/env python3
"""Time the int8 codec kernels of two or more checkouts on one card, in turns.

    python3 scripts/codec_ab.py --trees OLD NEW

Each tree is a directory holding a checkout's ``chip_smoke.py`` and
``src/`` (for the parent commit: ``git archive HEAD | tar -x -C DIR``).
Each is run in a process of its own, in the order A B B A (a palindrome
for more trees), so a drift of the card's clock lands on every side.  The
process builds that tree's kv_codec library and times quantize and
dequantize with the tree's own ``chip_smoke._codec_times`` (CUDA-graph
replay) on the same seeded inputs: a qwen3-14b serve block (16 x 81920
float16), a minicpm3-4b latent slab (16 x 17856 bfloat16) and 4096 x 8192
bfloat16.  Prints the card, one line per run and the median of each case
per tree, in ms.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

CASES = ("quantize serve", "quantize slab", "quantize large", "dequantize serve", "dequantize slab",
         "dequantize large")

CHILD = r"""
import json, sys
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import torch
import chip_smoke

g = torch.Generator(device="cuda").manual_seed(4)

def randn(*shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=g, device="cuda").mul_(4).to(dtype)

rq, rd = {}, {}
for key, x, out, iters in ((None, randn(16, 81920, dtype=torch.float16), torch.float16, 200),
                           ("slab", randn(16, 17856), torch.bfloat16, 200),
                           ("large", randn(4096, 8192), torch.bfloat16, 20)):
    chip_smoke._codec_times(rq, rd, key, x, out, iters)
res = {f"{name} {key or 'serve'}": (rec[key] if key else rec)["ms"]
       for name, rec in (("quantize", rq), ("dequantize", rd)) for key in (None, "slab", "large")}
print("RESULT " + json.dumps(res), flush=True)
"""


def run(tree: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree} failed (exit {proc.returncode}):\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", required=True, help="checkout directories, the first the baseline")
    args = ap.parse_args()
    trees = [os.path.abspath(t) for t in args.trees]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card={smi}", flush=True)
    results = {t: [] for t in trees}
    for t in trees + trees[::-1]:
        res = run(t)
        results[t].append(res)
        print(f"run tree={t} " + " ".join(f"{k.replace(' ', '_')}={v:.5f}" for k, v in res.items()), flush=True)
    base = {c: statistics.median(r[c] for r in results[trees[0]]) for c in CASES}
    for t in trees:
        med = {c: statistics.median(r[c] for r in results[t]) for c in CASES}
        print(f"median tree={t} " + " ".join(f"{c.replace(' ', '_')}={med[c]:.5f}({med[c] / base[c]:.3f}x)"
                                            for c in CASES), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
