"""End-to-end serving with the PyTorch port: the workload of
``examples/serve_e2e.py`` through ServingEngine -> CacheHierarchy ->
ShardedKVBlockStore on disk, with real prefill and decode on the card
through the port's flash and paged decode kernels.

    PYTHONPATH=src python examples/serve_e2e_torch.py                  # qwen3-14b, full width, cuda
    PYTHONPATH=src python examples/serve_e2e_torch.py --smoke --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.launch.serve_e2e import main  # noqa: E402


def cli():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true", help="reduced same-family config")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    main(arch=args.arch, smoke=args.smoke, device=args.device, seed=args.seed)
    print("ok")


if __name__ == "__main__":
    cli()
