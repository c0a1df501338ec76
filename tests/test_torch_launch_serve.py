"""The port's serve launcher (``repro_torch.launch.serve``) and its engine
builder against the reference's (``repro.launch.serve`` and
``benchmarks/common.py``) on the CPU: the same staged workload gives the
same hit rate per stage through both packages' engines, the launcher
prints the reference's lines, and ``launch/mesh.py`` holds the H100's
constants and none of the TPU's."""

import re
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the repository root, home of benchmarks/
from benchmarks import common  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro_torch.launch import mesh, serve  # noqa: E402

SCALE = dict(prompt_len=64, requests_per_stage=4, stages=(0.2, 0.5), corpus_size=16)


@pytest.mark.parametrize("kind", ["lsm", "memory"])
def test_run_staged_hits_match_reference(tmp_path, kind):
    """Hit rate per stage through the port's ``make_engine`` and
    ``run_staged`` equals the reference's, on the same workload and
    budgets (both engines are byte-identical copies; the builders must
    wire them alike)."""
    got = serve.run_staged(serve.make_engine(str(tmp_path / "port"), kind, serve.BenchScale(**SCALE)),
                           serve.BenchScale(**SCALE))
    want = common.run_staged(common.make_engine(str(tmp_path / "ref"), kind, common.BenchScale(**SCALE)),
                             common.BenchScale(**SCALE))
    assert [(r.stage, r.expected_hit, r.hit_rate) for r in got] == \
        [(r.stage, r.expected_hit, r.hit_rate) for r in want]
    assert serve._budgets(serve.BenchScale(**SCALE)) == common._budgets(common.BenchScale(**SCALE))
    assert all(r.mean_ttft_s > 0 for r in got)


def test_run_staged_ttft_is_the_service_time(tmp_path):
    """A stage is submitted at once; its TTFT is each request's service
    time, I/O plus modeled compute, as the reference's, and leaves out the
    wait behind the stage's earlier requests that the engine's
    ``RequestRecord.ttft_s`` includes."""
    got = serve.run_staged(serve.make_engine(str(tmp_path), "lsm", serve.BenchScale(**SCALE)),
                           serve.BenchScale(**SCALE))
    for r in got:
        assert r.mean_ttft_s == pytest.approx(r.mean_io_s + r.mean_compute_s, rel=1e-9)


def test_engine_builder_defaults_and_backends_match_reference(tmp_path):
    s, r = serve.BenchScale(), common.BenchScale()
    assert s.__dict__ == r.__dict__
    eng = serve.make_engine(str(tmp_path), "memory", serve.BenchScale(**SCALE))
    assert eng.compute.cfg.name == "glm4-9b"  # the default arch, as the reference's
    for kind in ("lsm", "lsm-sharded", "file"):
        store = serve.make_backend(str(tmp_path / kind), kind, serve.BenchScale(**SCALE))
        ref = common.make_backend(str(tmp_path / f"ref_{kind}"), kind, common.BenchScale(**SCALE))
        assert type(store).__name__ == type(ref).__name__
        store.close()
        ref.close()
    with pytest.raises(ValueError):
        serve.make_backend(str(tmp_path), "tape", serve.BenchScale())


def _table(text):
    """(stage, exp_hit, hit) of each stage row the launcher printed."""
    rows = re.findall(r"^\s*(\d+)\s+([\d.]+)\s+([\d.]+)\s+[\d.]+\s+[\d.]+$", text, re.M)
    return [tuple(r) for r in rows]


def test_launcher_prints_the_reference_lines(tmp_path, capsys, monkeypatch):
    args = ["--prompt-len", "64", "--requests", "4", "--stages", "0.2,0.5"]
    serve.main(args + ["--root", str(tmp_path / "port")])
    got = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["serve"] + args + ["--root", str(tmp_path / "ref")])
    jax_serve.main()
    want = capsys.readouterr().out
    assert got.splitlines()[:2] == want.splitlines()[:2]  # "[launch.serve] arch=..." and the header
    assert _table(got) == _table(want) and len(_table(got)) == 2
    assert re.search(r"^\[store\] files=\d+ disk=[\d.]+MB compression=[\d.]+x$", got, re.M)


def test_mesh_holds_the_h100_constants_and_no_tpu_constant():
    consts = {k: v for k, v in vars(mesh).items() if k.isupper()}
    assert consts == {"PEAK_FLOPS_BF16": 989e12, "PEAK_FLOPS_TF32": 494.7e12, "HBM_BW": 3.35e12,
                      "NVLINK_BW": 900e9, "IB_BW": 50e9, "CARDS_PER_HOST": 8}
    assert not {197e12, 819e9} & set(consts.values()) and "ICI_BW" not in consts
    # IB_BW is the HGX H100 host's InfiniBand (8 x 400 Gb/s ConnectX-7 per 8
    # cards), which equals the v5e's ICI figure by coincidence
    assert "datasheet" in mesh.__doc__ and "ConnectX-7" in mesh.__doc__
