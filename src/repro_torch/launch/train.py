"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--smoke|--full] [--device cuda|cpu] [--data N] [--model 1]``, one process
per card under ``torchrun`` (``torchrun --nproc-per-node N -m
repro_torch.launch.train --data N``), or a single process.

Runs (or resumes) the auto-resuming train loop under a (data, model) mesh
(``launch.mesh.make_smoke_mesh``): the eager train step, data-parallel
over ``data`` (forward and backward through the kernels' plain versions,
gradients mean-reduced, then the in-place AdamW update), a checkpoint
every ``--ckpt-every`` steps.  As in the reference, the parameter
shardings are computed and not used, and ``--compress-grads`` is parsed
and not read.  ``--model`` over 1 (tensor parallelism) raises: it waits
for the models' sharding constraints.

The defaults are those of one card: ``--data`` the world size, ``--model``
1 (the reference's 2 x 2 host mesh needs 4 ranks and a model axis).  A
full config does not fit one card with its optimizer state (qwen3-14b
needs ~177 GB), so the default is the reduced smoke config, as in the
reference; ``--layers`` cuts a config's depth.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch.distributed as dist

from ..configs import get_config
from ..distributed import sharding as shd
from ..models import api
from ..training.loop import TrainConfig, require_data_parallel, train
from .mesh import init_process_group, make_smoke_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--layers", type=int, default=None, help="cut the config to this many layers")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data", type=int, default=None, help="data-parallel ranks (default: the world size)")
    ap.add_argument("--model", type=int, default=1, help="tensor-parallel ranks; over 1 raises")
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 error-feedback DP gradient compression: parsed and not read, as in the reference")
    args = ap.parse_args(argv)
    require_data_parallel(args.model)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    opened = init_process_group(args.device)
    try:
        data = dist.get_world_size() if args.data is None else args.data
        mesh = make_smoke_mesh(data, args.model, device=args.device)
        print(f"[launch.train] arch={cfg.name} mesh={shd.axis_sizes(mesh)} device={args.device}")
        p_sh = shd.param_shardings(mesh, api.param_specs(cfg))  # noqa: F841  (unused, as in the reference)
        t0 = time.time()
        res = train(
            cfg,
            TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir),
            device=args.device,
            mesh=mesh,
        )
        print(f"[launch.train] {res['step']} steps in {time.time()-t0:.1f}s; "
              f"final loss {res['losses'][-1]:.4f} (resumed from {res['resumed_from']})")
    finally:
        if opened:
            dist.destroy_process_group()
    return res


if __name__ == "__main__":
    main()
