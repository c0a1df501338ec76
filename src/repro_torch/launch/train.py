"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--smoke|--full] [--device cuda|cpu] [--data N] [--model M]``, one process
per card under ``torchrun`` (``torchrun --nproc-per-node 4 -m
repro_torch.launch.train``), or a single process.

Runs (or resumes) the auto-resuming train loop under a (data, model) mesh
(``launch.mesh.make_smoke_mesh``): the eager train step, data-parallel
over ``data`` and tensor-parallel over ``model`` (forward and backward
through the kernels' plain versions, split at the reference's constrain
sites; gradients summed over ``model`` where the splits leave them
partial and mean-reduced over ``data``; then the in-place AdamW update),
a checkpoint every ``--ckpt-every`` steps.  As in the reference, the
parameter shardings are computed and not used (every rank holds the
whole parameters), and ``--compress-grads`` is parsed and not read.

The mesh (``mesh_shape``): the reference's defaults, ``--data 2 --model
2``, when the world has 4 ranks; otherwise ``--data`` the world size and
``--model`` 1; an axis given alone takes the rest of the world for the
other.  A full config does not fit one card with its optimizer state
(qwen3-14b needs ~177 GB), so the default is the reduced smoke config, as
in the reference; ``--layers`` cuts a config's depth.
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
from ..training.loop import TrainConfig, train
from .mesh import init_process_group, make_smoke_mesh


def mesh_shape(world: int, data=None, model=None):
    """(data, model) for a world of ``world`` ranks from the flags given
    (None where not given); ``make_smoke_mesh`` checks the product."""
    if data is None and model is None:
        return (2, 2) if world == 4 else (world, 1)
    if data is None:
        return max(1, world // model), model
    if model is None:
        return data, max(1, world // data)
    return data, model


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
    ap.add_argument("--data", type=int, default=None,
                    help="data-parallel ranks (default: 2 on 4 ranks, else the world size / --model)")
    ap.add_argument("--model", type=int, default=None,
                    help="tensor-parallel ranks (default: 2 on 4 ranks, else the world size / --data, or 1)")
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 error-feedback DP gradient compression: parsed and not read, as in the reference")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    opened = init_process_group(args.device)
    try:
        mesh = make_smoke_mesh(*mesh_shape(dist.get_world_size(), args.data, args.model), device=args.device)
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
