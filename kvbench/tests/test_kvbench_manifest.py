"""A lint of BENCHMARK.json against the benchmark's rules: names and units
in the allowed characters, every cell's files found by name, every
configuration's architecture module found and accepting the program's
config, every per-layer metric's ``moves`` reported in each of its cells,
and the check time of a full benchmark within its budget."""

import re

import pytest

from kvbench import arch
from kvbench import cell as cellmod
from kvbench import run as kvrun
from kvbench.cell import HERE, ROOT, load_json

BENCH = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def line_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["kvbench"]
    assert len(BENCH["command"]) <= 32 and all(line_ok(w) for w in BENCH["command"])
    for w in BENCH["command"]:
        assert not w.startswith("/") and ".." not in w
        if "/" in w:
            assert any(w.startswith(p + "/") for p in BENCH["paths"])
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check at 24 cells: 2 + 14 runs a cell, each run_seconds + 60, 2 x 90 a cell, 1200 spare
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_unique():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in METRICS]
    assert all(NAME.match(n) for n in names)
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({x["name"] for x in group}) == len(group)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_configs():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("kvbench/") and (ROOT / c["file"]).exists()
        assert line_ok(c["why"]) and line_ok(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        f = load_json(ROOT / c["file"])
        assert f["name"] == c["name"] and f["source"] == c["source"] and f["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_configuration_names_an_architecture_module_that_accepts_it(name):
    conf = load_json(ROOT / next(c["file"] for c in BENCH["configs"] if c["name"] == name))
    module = conf.get("arch", arch.DEFAULT)
    assert NAME.match(module) and (HERE / "arch" / f"{module}.py").exists()
    kvrun.port_config(conf)  # raises where the module's check_config refuses the program's config


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    w = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert name == f"{w['config']}.{w['traffic']}" and w["chips"] == 1 and line_ok(w["why"])
    assert NAME.match(w["traffic"])
    c = cellmod.resolve(name)
    assert (HERE / "runners" / f"{c.traffic['runner']}.py").exists()
    assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert (HERE / "metrics" / f"{m}.py").exists()
    assert c.limits is not None, f"no kvbench/limits/{name}.json"


def test_metrics_and_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert all(c in CELLS for c in m.get("workloads", []))
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line_ok(m["layer"]) and m["moves"] in e2e
        for c in m["workloads"]:
            assert c in CELLS
            assert m["moves"] in cellmod.resolve(c).end_to_end, (m["name"], c)
