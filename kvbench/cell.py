"""A cell of ``BENCHMARK.json`` resolved by name to its files: the
configuration (``configs[].file``) with its architecture module
(``kvbench/arch/<arch>.py``), the traffic mix
(``kvbench/traffic/<traffic>.json``), its correctness limits
(``kvbench/limits/<cell>.json``) and its metrics (each a reader
``kvbench/metrics/<metric>.py``)."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

from . import arch as archmod

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict  # the configuration file
    traffic: Dict  # the traffic file
    limits: Optional[Dict[str, float]]
    end_to_end: List[str]
    per_layer: List[str]
    units: Dict[str, str]

    @property
    def arch(self) -> ModuleType:
        """The configuration's architecture module."""
        return archmod.of(self.config)


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: Dict, cell: str, e2e_of_cell: List[str]) -> bool:
    """Whether ``cell`` reports ``metric``: listed in its ``workloads``, or,
    without that key, in every cell that reports the end-to-end metric it
    moves (an end-to-end metric without the key: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_of_cell


def resolve(name: str, bench: Optional[Dict] = None) -> Cell:
    bench = load_json(ROOT / "BENCHMARK.json") if bench is None else bench
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    limits_path = HERE / "limits" / f"{name}.json"
    e2e = [m["name"] for m in bench["end_to_end"] if reports(m, name, [])]
    per_layer = [m["name"] for m in bench["per_layer"] if reports(m, name, e2e)]
    return Cell(name=name, chips=int(wl["chips"]), config=load_json(ROOT / conf["file"]),
                traffic=load_json(HERE / "traffic" / f"{wl['traffic']}.json"),
                limits=load_json(limits_path)["limits"] if limits_path.exists() else None,
                end_to_end=e2e, per_layer=per_layer,
                units={m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]})


def reader(metric: str) -> Callable[[Dict], Optional[float]]:
    """``read(run)`` of ``kvbench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"kvbench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def runner(name: str):
    return importlib.import_module(f"kvbench.runners.{name}")


def generator(spec: Dict, vocab: int, seed: int):
    """The traffic file's generator: class ``cls`` of ``kvbench/traffic/<module>.py``."""
    mod = importlib.import_module(f"kvbench.traffic.{spec['module']}")
    return getattr(mod, spec["cls"])(spec["params"], vocab, seed)
