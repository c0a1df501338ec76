"""The control comes out not correct: the reference computed in fp8 (every
matrix product's operands rounded to float8 e4m3, the precision below the
configurations' bf16) put in the program's place fails a number of each
cell, and the program's own bf16 run passes.  On the CPU at a test size
deep enough for the control's error to build up as over a full model (16
layers); on the card at the cell's own size (``--control 1`` runs the
control on the run's own sample after the window)."""

import json
import subprocess
import sys

import pytest
import torch

from kvbench import check
from kvbench import run as kvrun
from kvbench.cell import ROOT, load_json
from kvbench.tests.smoke import smoke_cell

CELLS = [w["name"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("seed", [11, 2**31 + 1, 3_000_000_019])
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits_at_test_size(name, seed):
    cell = smoke_cell(name, size="control")
    out = kvrun.run_cell(cell, seed, 3.0, False, torch.device("cpu"), control=True)
    assert out["correct"], out["checks"]
    assert not check.verdict(out["extra"]["control"], cell.limits), out["extra"]["control"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control at the cell's own size runs on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits_at_cell_size(card, name):
    limits = load_json(ROOT / "kvbench" / "limits" / f"{name}.json")["limits"]
    for seed in (3_100_000_001, 3_100_000_002, 3_100_000_003):
        res = subprocess.run([sys.executable, "kvbench/run.py", "--workload", name, "--seed", str(seed),
                              "--seconds", "20", "--trace", "0", "--control", "1"],
                             capture_output=True, text=True, timeout=900, cwd=ROOT)
        assert res.returncode == 0, res.stderr[-3000:]
        ctl = next(line for line in res.stderr.splitlines() if line.startswith("kvbench control "))
        readings = {k: float(v) for k, v in (kv.split("=") for kv in ctl.split()[2:])}
        assert not check.verdict(readings, limits), readings
        assert json.loads(res.stdout.strip().splitlines()[-1])["correct"]
