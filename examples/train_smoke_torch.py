"""Train an LM with the PyTorch port (the smoke config unless ``--full``),
with checkpoints and auto-resume: kill it mid-run and re-run with the same
``--ckpt-dir``, and it resumes from the newest committed checkpoint and
replays the trajectory.

    PYTHONPATH=src python examples/train_smoke_torch.py [--steps 200]      # on the card
    PYTHONPATH=src python examples/train_smoke_torch.py --smoke --device cpu
    PYTHONPATH=src python examples/train_smoke_torch.py --simulate-crash --steps 12 --ckpt-every 3

``--simulate-crash`` runs the uninterrupted trajectory, then a run that
crashes at 40 % and one that auto-resumes, and exits nonzero unless the
losses after the resume replay the uninterrupted ones (rtol 1e-5, atol
1e-6: the reference's own check, tests/test_training.py).  For that it
turns on ``torch.use_deterministic_algorithms`` before the device is
first used.  The last line is a JSON object with both loss lists.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

RTOL, ATOL = 1e-5, 1e-6


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--smoke", action="store_true", default=True, help="reduced same-family config (default)")
    ap.add_argument("--full", dest="smoke", action="store_false", help="the published config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=None, help="default: max(10, steps // 10)")
    ap.add_argument("--simulate-crash", action="store_true",
                    help="crash at 40% then auto-resume, asserting identical losses")
    args = ap.parse_args()

    if args.simulate_crash:  # a replay must be bit-reproducible: cuBLAS needs its workspace fixed first
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.training.loop import TrainConfig, train

    if args.simulate_crash:
        torch.use_deterministic_algorithms(True)
    cfg = get_config(args.arch, smoke=args.smoke)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="train_smoke_")
    every = args.ckpt_every or max(10, args.steps // 10)

    def tcfg(where):
        return TrainConfig(steps=args.steps, ckpt_every=every, ckpt_dir=where, log_every=max(1, args.steps // 10))

    ok = True
    try:
        if args.simulate_crash:
            full = train(cfg, tcfg(os.path.join(ckpt_dir, "full")), device=args.device)
            crash_at = int(args.steps * 0.4)
            print(f"[example] running to step {crash_at}, then crashing ...")
            r1 = train(cfg, tcfg(os.path.join(ckpt_dir, "crash")), crash_after=crash_at, device=args.device)
            assert r1["crashed"]
            print(f"[example] crashed at {r1['step']}; restarting (auto-resume) ...")
            r2 = train(cfg, tcfg(os.path.join(ckpt_dir, "crash")), device=args.device)
            k = r2["resumed_from"]
            print(f"[example] resumed from step {k}, finished at {r2['step']}")
            gap = float(np.max(np.abs(np.subtract(r2["losses"], full["losses"][k:]))))
            ok = bool(np.allclose(r2["losses"], full["losses"][k:], rtol=RTOL, atol=ATOL))
            print(f"[example] losses after the resume vs uninterrupted: max |gap| {gap:.3e} "
                  f"(rtol {RTOL}, atol {ATOL}): {'ok' if ok else 'MISMATCH'}")
            print(json.dumps({"resumed_from": k, "full": full["losses"], "resumed": r2["losses"]}))
        else:
            res = train(cfg, tcfg(ckpt_dir), device=args.device)
            print(f"[example] done: {res['step']} steps, "
                  f"loss {res['losses'][0]:.3f} -> {res['losses'][-1]:.3f}")
    finally:
        if args.ckpt_dir is None:  # a directory of its own: nothing can resume from it
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
