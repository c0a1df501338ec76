"""Multi-pod dry run (the reference's ``launch/dryrun.py``).

For every (architecture x input-shape) cell, trace the port's own step
(``launch.steps.lower_cell``) as rank 0 of the production mesh, 1-pod
(16 data x 16 model = 256 cards) or 2-pod (2 pod x 16 data x 16 model =
512 cards), and write one JSON record per cell with the reference's keys:
the memory a card holds (``memory_analysis``), per-device FLOPs, bytes and
collectives (``cost_analysis``, ``collectives``) and the roofline terms in
the H100's constants (``roofline``).  Records go under
``build/dryrun_torch/`` (the smoke configs' under its ``smoke/``).

It is a planning tool, and it runs where the process runs: the step is
traced on ``meta`` tensors in a fake process group (``launch.mesh.fake_mesh``),
so it needs no CUDA and no card, and it touches none.  Nothing is compiled
(``compile_s`` is null).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k --pods 1
  python -m repro_torch.launch.dryrun --all --pods 1,2        # every cell, subprocesses
  python -m repro_torch.launch.dryrun --all --missing-only --smoke
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build", "dryrun_torch")


def cell_path(arch: str, shape: str, pods: int, smoke: bool = False, root: str = ART_DIR) -> str:
    return os.path.join(root, "smoke" if smoke else "", f"{arch}__{shape}__{pods}pod.json")


def run_cell(arch: str, shape_name: str, pods: int, smoke: bool = False, root: str = ART_DIR) -> dict:
    from ..configs import SHAPES, get_config
    from . import steps
    from .mesh import production_mesh_shape
    from .roofline import extract

    cfg = get_config(arch, smoke=smoke)
    shape = SHAPES[shape_name]
    mesh = production_mesh_shape(multi_pod=(pods == 2))
    chips = 1
    for n in mesh.shape:
        chips *= n

    rec = {"arch": arch, "shape": shape_name, "pods": pods, "chips": chips, "ok": False, "smoke": smoke,
           "traced_on": "meta tensors in this process, as rank 0 of a fake process group; no device"}
    lowered = steps.lower_cell(mesh, cfg, shape)
    rec["lower_s"] = round(lowered.lower_s, 2)
    rec["compile_s"] = None  # nothing compiles: the step is eager PyTorch
    rec["seq_shard"] = lowered.seq_shard
    rec["memory_analysis"] = lowered.memory_analysis()
    rl, coll = extract(lowered, cfg, shape, chips)
    rec["cost_analysis"] = {"flops": rl.flops, "bytes_accessed": rl.hbm_bytes,
                            "matmul_flops": lowered.totals.matmul_flops, "ops": lowered.totals.ops}
    rec["collectives"] = {"bytes_by_op": coll.bytes_by_op, "count_by_op": coll.count_by_op,
                          "bytes_by_axis": coll.bytes_by_axis,
                          "bytes_by_axis_op": {a: dict(k) for a, k in lowered.totals.coll_bytes_by_axis_op.items()}}
    rec["roofline"] = rl.to_dict()
    rec["ok"] = True

    path = cell_path(arch, shape_name, pods, smoke, root)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)

    print(f"[dryrun] {arch}{' (smoke)' if smoke else ''} x {shape_name} x {pods}-pod ({chips} cards): OK "
          f"(traced on meta in {rec['lower_s']}s, no device)")
    print(f"  memory_analysis: {rec['memory_analysis']}")
    print(f"  cost_analysis: flops/device={rl.flops:.3e} bytes/device={rl.hbm_bytes:.3e}")
    print(f"  collectives: {coll.bytes_by_op} by axis {coll.bytes_by_axis} "
          f"(across hosts {rl.ib_bytes:.3e})")
    print(f"  roofline: compute={rl.compute_s * 1e3:.2f}ms memory={rl.memory_s * 1e3:.2f}ms "
          f"collective={rl.collective_s * 1e3:.2f}ms -> bottleneck={rl.bottleneck} mfu={rl.mfu:.3f}")
    return rec


def run_all(pods_list, missing_only: bool, smoke: bool = False, root: str = ART_DIR, timeout_s: int = 3600) -> int:
    """Every unskipped cell of ``configs.cells()`` on each mesh of
    ``pods_list``, one subprocess a cell (a cell's fake process group is
    its process's); returns the number that failed."""
    from ..configs import cells

    todo = [(arch, shape_name, pods) for pods in pods_list
            for arch, shape_name, skip in cells(include_skipped=True)
            if not skip and not (missing_only and os.path.exists(cell_path(arch, shape_name, pods, smoke, root)))]
    print(f"[dryrun] {len(todo)} cells to run")
    failures = 0
    t0 = time.time()
    for arch, shape_name, pods in todo:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape_name,
               "--pods", str(pods), "--out", root] + (["--smoke"] if smoke else [])
        r = subprocess.run(cmd, timeout=timeout_s)
        if r.returncode != 0:
            failures += 1
            print(f"[dryrun] FAIL {arch} x {shape_name} x {pods}-pod (rc={r.returncode})")
    print(f"[dryrun] done: {len(todo) - failures}/{len(todo)} ok in {time.time() - t0:.1f}s")
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser(description="Dry run of the port's steps on meta tensors (no device)")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--pods", default="1")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--missing-only", action="store_true")
    ap.add_argument("--smoke", action="store_true", help="the reduced same-family configs")
    ap.add_argument("--out", default=ART_DIR, help="the records' directory (default build/dryrun_torch)")
    args = ap.parse_args(argv)

    pods_list = [int(p) for p in str(args.pods).split(",")]
    if args.all:
        sys.exit(1 if run_all(pods_list, args.missing_only, args.smoke, args.out) else 0)
    try:
        run_cell(args.arch, args.shape, pods_list[0], smoke=args.smoke, root=args.out)
    except Exception:
        traceback.print_exc()
        sys.exit(1)


if __name__ == "__main__":
    main()
