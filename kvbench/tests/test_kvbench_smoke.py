"""Both runners end to end on the CPU at test size (the smoke variants of
the configured models, the kernels' plain versions), sound runs correct
under the cells' limits, and no module of ``jax``, ``jaxlib``, ``flax`` or
the JAX package ``repro`` loaded by a run."""

import json
import subprocess
import sys
import textwrap

import pytest
import torch

from kvbench import run as kvrun
from kvbench.cell import ROOT, load_json
from kvbench.tests.smoke import smoke_cell

CELLS = [w["name"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]]


def run_smoke(name, trace=False, faults=None, seed=2**31 + 77, seconds=1.0):
    return kvrun.run_cell(smoke_cell(name), seed, seconds, trace, torch.device("cpu"), faults=faults)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = run_smoke(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    e2e = out["metrics"]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert list(out)[-2:] == ["checks", "extra"]  # run.py prints the line without "extra": "checks" last


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_per_layer_metrics(name):
    out = run_smoke(name, trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"] and "breakdown" in out
    assert out["device"]["window_s"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_a_run_loads_no_jax_and_no_reference_package(name):
    code = textwrap.dedent(f"""
        import json, sys
        sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
        import torch
        from kvbench import run as kvrun
        from kvbench.tests.smoke import smoke_cell
        out = kvrun.run_cell(smoke_cell({name!r}), 5, 0.5, False, torch.device("cpu"))
        print(json.dumps({{"correct": out["correct"], "bad": kvrun.forbidden_modules(),
                           "torch_port": "repro_torch" in sys.modules}}))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "bad": [], "torch_port": True}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert kvrun.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert kvrun.forbidden_modules() == ["repro"]


def test_run_py_refuses_without_a_card():
    res = subprocess.run([sys.executable, "kvbench/run.py", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA device" in res.stderr
