"""Run one cell of the benchmark once and print its result as the last line
of standard output.

    python3 kvbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1> [--control 0|1]

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (a device trace of a sub-window, the benchmark's own host
spans).  ``--control 1`` also reads the control (the reference in fp8 put
in the program's place) on the same sample; the benchmark's own runs leave
it off.  Exits nonzero, printing no result, without enough CUDA devices,
without the program, or if ``jax``, ``jaxlib``, ``flax`` or ``repro`` was
imported by the end of the window.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_dirs(root: Path) -> Dict[str, str]:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = root / "build" / "kvbench_cache"
    return {"TRITON_CACHE_DIR": str(base / "triton"), "TORCH_EXTENSIONS_DIR": str(base / "torch_extensions")}


class Phases:
    """Set-up seconds by phase, in order."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def timed(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t


class Context:
    """What a runner gets: the cell's files, the run's arguments, the set-up
    clock and the helpers around the device."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device, control: bool,
                 faults: Optional[Dict[str, Callable]] = None, t_start: float = T_START):
        from kvbench import cell as cellmod

        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.control = device, control
        self.traffic, self.model, self.arch = cell.traffic, cell.config["model"], cell.arch
        self.port_cfg = port_config(cell.config)
        self.phases = Phases()
        self.generator = cellmod.generator
        self._faults = faults or {}
        self.t_start = t_start
        self.setup_s: Optional[float] = None

    def window_start(self) -> float:
        """Set-up ends here: the clock at the first timed request."""
        now = time.perf_counter()
        self.setup_s = now - self.t_start
        return now

    def fault(self, where: str, fn):
        """``fn``, or the fault a test planted at ``where`` wrapped around it."""
        f = self._faults.get(where)
        return fn if f is None else f(fn)

    def memory_peak(self) -> int:
        import torch

        if self.device.type == "cuda":
            return int(torch.cuda.max_memory_allocated(self.device))
        return 0

    def free(self) -> None:
        import torch

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def port_config(config: Dict):
    """The program's ModelConfig the file runs: the port's registered
    config (its smoke variant where the file says so) with the file's
    overrides, checked by the file's architecture module against the
    file's ``model`` object."""
    import dataclasses

    from kvbench import arch
    from repro_torch.configs import get_config

    cfg = get_config(config["port_config"], smoke=bool(config.get("smoke", False)))
    cfg = dataclasses.replace(cfg, **config.get("port_overrides", {}))
    arch.of(config).check_config(cfg, config)
    return cfg


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def run_cell(cell, seed: int, seconds: float, trace: bool, device, control: bool = False,
             faults: Optional[Dict[str, Callable]] = None, t_start: float = T_START) -> Dict:
    """Drive the cell once and return the result object (the last line's
    keys, ``checks`` last, plus ``setup`` and ``control`` for the lines
    before it)."""
    from kvbench import cell as cellmod, check, procio

    ctx = Context(cell, seed, seconds, trace, device, control, faults, t_start)
    runner = cellmod.runner(cell.traffic["runner"])
    run = runner.run(ctx)
    run["setup_s"] = ctx.setup_s
    names = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for name in names:
        v = cellmod.reader(name)(run)
        if v is not None:
            metrics[name] = {"value": v, "unit": cell.units[name]}
    nums = run["numbers"]
    limits = cell.limits or {}
    checks = {k: {"value": finite_or_str(v), "limit": limits.get(k)} for k, v in nums.items()}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": device_kind(device), "count": cell.chips, "memory_peak_bytes": run["memory_peak_bytes"]}
    out = {"correct": check.verdict(nums, cell.limits), "attempted": len(run["requests"]) + run.get("late", 0),
           "failed": 0, "metrics": metrics, "device": dev}
    prof = run.get("profile")
    if trace and prof is not None:
        dev["busy_s"], dev["window_s"] = prof["busy_s"], prof["window_s"]
        out["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    out["checks"] = checks
    out["extra"] = {"setup": dict(ctx.phases.seconds, setup_s=ctx.setup_s), "written_bytes": procio.wchar(),
                    "control": run.get("control"), "sampled": run.get("sampled"), "check_s": run.get("check_s"),
                    "requests": [{k: round(v, 6) for k, v in r.items() if isinstance(v, float)} for r in run["requests"]]}
    return out


def device_kind(device) -> str:
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def finite_or_str(v):
    """A reading as JSON can hold it: ``inf`` or ``nan`` (a block missing)
    as a string."""
    return v if math.isfinite(v) else str(v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    os.environ.update(cache_dirs(ROOT))
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from kvbench import cell as cellmod

    cell = cellmod.resolve(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"kvbench: {a.workload} needs {cell.chips} CUDA device(s), found {n}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    try:
        import repro_torch  # noqa: F401
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"kvbench: the program is not here: {e}", file=sys.stderr)
        return 2
    t = time.perf_counter()
    _build.build_all(list(cell.arch.KERNELS))
    build_s = time.perf_counter() - t

    out = run_cell(cell, a.seed, a.seconds, bool(a.trace), device, control=bool(a.control))
    extra = out.pop("extra")
    bad = forbidden_modules()
    if bad:
        print(f"kvbench: modules loaded that the benchmark forbids: {bad}", file=sys.stderr)
        return 3

    setup = {"import_s": t - T_START, "build_s": build_s, **extra["setup"]}
    print("kvbench setup " + " ".join(f"{k}={v!r}" for k, v in setup.items()), file=sys.stderr)
    print(f"kvbench written_bytes={extra['written_bytes']} sampled_requests={extra['sampled']} "
          f"check_s={extra['check_s']!r}", file=sys.stderr)
    if extra["control"] is not None:
        print("kvbench control " + " ".join(f"{k}={v!r}" for k, v in extra["control"].items()), file=sys.stderr)
    print("kvbench requests " + json.dumps(extra["requests"]), file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"kvbench check {k}={c['value']!r} limit={c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
