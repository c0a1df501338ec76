"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--smoke|--full] [--device cuda|cpu]``.

Runs (or resumes) the auto-resuming train loop on one device: the eager
train step (forward and backward through the kernels' plain versions, then
the in-place AdamW update), a checkpoint every ``--ckpt-every`` steps.  The
reference's mesh flags (``--data``, ``--model``, ``--compress-grads``) wait
for the port's distributed layer.  A full config does not fit one card
with its optimizer state (qwen3-14b needs ~177 GB), so the default is the
reduced smoke config, as in the reference.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

from ..configs import get_config
from ..training.loop import TrainConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    print(f"[launch.train] arch={cfg.name} device={args.device}")
    t0 = time.time()
    res = train(
        cfg,
        TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir),
        device=args.device,
    )
    print(f"[launch.train] {res['step']} steps in {time.time()-t0:.1f}s; "
          f"final loss {res['losses'][-1]:.4f} (resumed from {res['resumed_from']})")
    return res


if __name__ == "__main__":
    main()
