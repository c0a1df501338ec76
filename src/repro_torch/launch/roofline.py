"""Roofline terms of a dry-run cell, in the H100's constants (the
reference's ``launch/roofline.py``):

    compute term    = FLOPs_per_device / PEAK_FLOPS_BF16             [s]
    memory term     = bytes_per_device / HBM_BW                      [s]
    collective term = NVLink bytes / NVLINK_BW + IB bytes / IB_BW    [s]

The counts are the cost counter's (``launch.cost``) for one rank's step
(``launch.steps.lower_cell``), so dividing by one card's peaks is the
reference's ``global / (chips x peak)``.  A collective whose group lies
inside one 8-card host crosses NVLink; one whose group spans hosts crosses
InfiniBand.  On the data-major (16, 16) mesh a ``model`` group is 16
consecutive ranks, two hosts, so its tensor parallelism runs over
InfiniBand, as the ``data`` groups do.  A collective's bytes are its
operand's, whatever its kind, the reference's convention: an all-reduce's
buffer, an all-gather's input (a rank's rows) and a reduce-scatter's
whole input (every rank's rows), each over the link's bandwidth.

``python -m repro_torch.launch.roofline [--pods 1] [--smoke]`` prints the
table over the dry-run records (``launch.dryrun``), as the reference's
``benchmarks/roofline.py`` does.
"""

from __future__ import annotations

import argparse
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .mesh import HBM_BW, IB_BW, NVLINK_BW, PEAK_FLOPS_BF16


@dataclass
class CollectiveSummary:
    bytes_by_op: Dict[str, int] = field(default_factory=dict)
    count_by_op: Dict[str, int] = field(default_factory=dict)
    bytes_by_axis: Dict[str, int] = field(default_factory=dict)


@dataclass
class Roofline:
    flops: float  # per-device flops
    hbm_bytes: float  # per-device bytes accessed
    collective_bytes: float  # per-device collective operand bytes
    chips: int
    model_flops: float = 0.0  # 6*N*D (dense) or 6*N_active*D
    ib_bytes: float = 0.0  # the part of collective_bytes whose groups span hosts

    peak_flops: float = PEAK_FLOPS_BF16
    hbm_bw: float = HBM_BW
    nvlink_bw: float = NVLINK_BW
    ib_bw: float = IB_BW

    @property
    def compute_s(self) -> float:
        return self.flops / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / self.hbm_bw

    @property
    def collective_s(self) -> float:
        return (self.collective_bytes - self.ib_bytes) / self.nvlink_bw + self.ib_bytes / self.ib_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s, "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flop_ratio(self) -> float:
        """MODEL_FLOPS / global flops: the remat and redundancy waste meter."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        denom = self.step_s * self.chips * self.peak_flops
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.collective_bytes,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_s": self.step_s,
            "useful_flop_ratio": self.useful_flop_ratio,
            "mfu": self.mfu,
            "collective_ib_bytes_per_device": self.ib_bytes,
        }


def model_flops_for(cfg, shape) -> float:
    """Analytic MODEL_FLOPS for the cell: 6·N·D(+attention) for train,
    2·N·D for inference (forward only), D = tokens processed this step."""
    n = cfg.active_param_count()
    attends = cfg.attention != "none" and cfg.family != "rwkv6"
    sites = cfg.n_layers if cfg.attn_every == 0 else cfg.n_layers // cfg.attn_every
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        base = 6.0 * n * tokens
        # causal attention flops: 6 * L * B * S^2/2 * H * Dh * 2 (fwd+bwd qk+av)
        if attends:
            base += 6.0 * sites * shape.global_batch * shape.seq_len**2 * cfg.n_heads * cfg.d_head
        return base
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        base = 2.0 * n * tokens
        if attends:
            base += 2.0 * sites * shape.global_batch * shape.seq_len**2 * cfg.n_heads * cfg.d_head
        return base
    # decode: one token per sequence
    base = 2.0 * n * shape.global_batch
    if attends:
        base += 4.0 * sites * shape.global_batch * shape.seq_len * cfg.n_heads * cfg.d_head
    return base


def extract(lowered, cfg, shape, chips: int):
    """(Roofline, CollectiveSummary) of a ``steps.LoweredCell``: its
    counter's per-device totals, the reference's ``extract`` on a compiled
    module."""
    tot = lowered.totals
    coll = CollectiveSummary({k: int(v) for k, v in tot.coll_bytes_by_op.items()},
                             {k: int(v) for k, v in tot.coll_count_by_op.items()},
                             {k: int(v) for k, v in tot.coll_bytes_by_axis.items()})
    return Roofline(flops=tot.flops, hbm_bytes=tot.bytes, collective_bytes=float(tot.collective_bytes),
                    chips=chips, model_flops=model_flops_for(cfg, shape),
                    ib_bytes=float(tot.coll_cross_host_bytes)), coll


# ------------------------------------------------------------------- table
def load_cells(pods: int = 1, smoke: bool = False, root: Optional[str] = None) -> List[Dict]:
    """Every cell of ``configs.cells(include_skipped=True)``: its dry-run
    record (under ``root``, ``dryrun.ART_DIR`` by default), or a row saying
    it is skipped or missing."""
    from ..configs import cells
    from .dryrun import ART_DIR, cell_path

    rows = []
    for arch, shape, skip in cells(include_skipped=True):
        if skip:
            rows.append({"arch": arch, "shape": shape, "skipped": skip})
            continue
        p = cell_path(arch, shape, pods, smoke, root or ART_DIR)
        if not os.path.exists(p):
            rows.append({"arch": arch, "shape": shape, "missing": True})
            continue
        with open(p) as f:
            rows.append(json.load(f))
    return rows


def table(rows: List[Dict]) -> List[str]:
    """The roofline table's lines: compute, memory and collective terms,
    the bottleneck, the useful-FLOP ratio and MFU, and the share of the
    collective bytes that crosses InfiniBand."""
    hdr = (f"{'arch':18s} {'shape':12s} {'compute':>10s} {'memory':>10s} {'coll':>10s} "
           f"{'bound':>10s} {'useful':>7s} {'MFU':>6s} {'IB':>5s}")
    out = [hdr, "-" * len(hdr)]
    for r in rows:
        if r.get("skipped"):
            out.append(f"{r['arch']:18s} {r['shape']:12s} SKIP ({r['skipped'][:48]})")
        elif r.get("missing"):
            out.append(f"{r['arch']:18s} {r['shape']:12s} MISSING")
        elif not r.get("ok"):
            out.append(f"{r['arch']:18s} {r['shape']:12s} FAILED")
        else:
            rl = r["roofline"]
            coll = rl["collective_bytes_per_device"]
            ib = rl["collective_ib_bytes_per_device"] / coll if coll else 0.0
            out.append(f"{r['arch']:18s} {r['shape']:12s} {rl['compute_s'] * 1e3:8.2f}ms {rl['memory_s'] * 1e3:8.2f}ms "
                       f"{rl['collective_s'] * 1e3:8.2f}ms {rl['bottleneck']:>10s} "
                       f"{rl['useful_flop_ratio']:7.3f} {rl['mfu']:6.3f} {ib:5.2f}")
    return out


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--smoke", action="store_true", help="the records of the smoke configs")
    ap.add_argument("--out", help="the records' directory (default build/dryrun_torch)")
    args = ap.parse_args(argv)
    rows = load_cells(args.pods, args.smoke, args.out)
    for ln in table(rows):
        print(ln)
    return rows


if __name__ == "__main__":
    main()
