"""The dry run of the port (``repro_torch.launch.steps.lower_cell``,
``launch.dryrun``, ``launch.roofline``) against the reference's
(``repro.launch.steps.lower_cell(...).compile()``, read by its
``roofline.extract``), run in a subprocess on 4 JAX host devices, as
``tests/test_distributed.py::test_lowering_pipeline_smoke_subprocess``
runs it, for qwen3-14b-smoke at B 8 x S 64 on the (1, 1) and (2, 2)
meshes.

What must agree, and how closely:
  * argument bytes: the rules' layout on rank 0 equals XLA's
    ``argument_size_in_bytes`` exactly (the same specs, the same shards);
  * train and prefill FLOPs within 10 %: the counter counts the port's
    eager ops (the remat recompute, AdamW's passes, the plain attention's
    masked full scores), hlocost the HLO after XLA's rewrites;
  * decode's matmul FLOPs equal the analytic count: 2 x B x the matmul
    parameters, and 4 x B x H x Dh x slots for the attention over the
    whole cache;
  * collectives: none at (1, 1); at (2, 2) the fake group's bytes of
    each kind (all-reduce; and in the train step, which splits the
    residual stream over sequence, all-gather and reduce-scatter) equal
    what the same steps hand ``dist.all_reduce``,
    ``dist.all_gather_into_tensor`` and ``dist.reduce_scatter_tensor`` on
    2 x 2 gloo ranks (``dist_harness.collective_ranks``);
  * the train step's FLOPs at (2, 2) under the 116,124,579 the port
    counted before it split the residual stream over sequence, whose
    elementwise work every model rank repeated.
Then ``model_flops_for`` in both packages for every cell, the CLI's
record and the roofline table, and one cell a family at (16, 16).
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import dist_harness as dh
from repro_torch.configs import SHAPES, cells, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import AbstractMesh
from repro_torch.launch import roofline, steps

SRC = Path(__file__).resolve().parents[1] / "src"
ARCH, B, S = "qwen3-14b", 8, 64
MESHES = [(1, 1), (2, 2)]
KINDS = ("train", "prefill", "decode")
FLOP_RTOL = 0.10

REFERENCE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    from repro.configs import get_config
    from repro.configs.base import ShapeConfig
    from repro.launch import steps
    from repro.launch.mesh import make_smoke_mesh
    from repro.launch.roofline import extract

    arch, B, S = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    cfg = get_config(arch, smoke=True)
    out = {}
    for data, model in ((1, 1), (2, 2)):
        mesh = make_smoke_mesh(data, model)
        for kind in ("train", "prefill", "decode"):
            shape = ShapeConfig(kind, S, B, kind)
            compiled = steps.lower_cell(mesh, cfg, shape).compile()
            rl, coll = extract(compiled, cfg, shape, data * model)
            out[f"{data}x{model}|{kind}"] = {"args": int(compiled.memory_analysis().argument_size_in_bytes),
                                             "flops": rl.flops, "coll": coll.bytes_by_op}
    print("REF " + json.dumps(out))
""")


def _env():
    return dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")


@pytest.fixture(scope="module")
def reference():
    r = subprocess.run([sys.executable, "-c", REFERENCE, ARCH, str(B), str(S)], capture_output=True, text=True,
                       env=_env(), timeout=300)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("REF ")]
    assert r.returncode == 0 and line, r.stderr[-3000:]
    return json.loads(line[0][4:])


@pytest.fixture(scope="module")
def port():
    cfg = get_config(ARCH, smoke=True)
    return {(m, k): steps.lower_cell(AbstractMesh(m, ("data", "model")), cfg, ShapeConfig(k, S, B, k))
            for m in MESHES for k in KINDS}


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """Rank 0's collective bytes by kind of each step on 4 gloo ranks at (2, 2)."""
    return dh.run_ranks(dh.collective_ranks, 4, str(tmp_path_factory.mktemp("ar")), ARCH, B, S)[0]


def _ids(m, k):
    return f"{m[0]}x{m[1]}-{k}"


@pytest.mark.parametrize("mesh,kind", [(m, k) for m in MESHES for k in KINDS], ids=lambda v: str(v))
def test_argument_bytes_equal_the_references(mesh, kind, port, reference):
    assert port[(mesh, kind)].argument_bytes == reference[f"{mesh[0]}x{mesh[1]}|{kind}"]["args"]


@pytest.mark.parametrize("mesh,kind", [(m, k) for m in MESHES for k in ("train", "prefill")], ids=lambda v: str(v))
def test_flops_within_ten_percent_of_hlocost(mesh, kind, port, reference):
    got, want = port[(mesh, kind)].totals.flops, reference[f"{mesh[0]}x{mesh[1]}|{kind}"]["flops"]
    assert abs(got - want) <= FLOP_RTOL * want, (got, want)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_decode_matmul_flops_equal_the_analytic_count(mesh, port):
    """Rank 0's B/data rows; at model 2 the smoke config (H 4, KVH 2)
    splits over query groups: half the q heads and o rows, every KV head,
    half the MLP hidden and the vocabulary."""
    cfg = get_config(ARCH, smoke=True)
    data, model = mesh
    rows, D, H, KVH, Dh, L = B // data, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.n_layers
    per_layer = 2 * D * (H // model) * Dh + 2 * D * KVH * Dh + 3 * D * (cfg.d_ff // model)
    params = L * per_layer + D * cfg.vocab_size // model
    attention = L * 4 * (H // model) * Dh * S  # q.k and p.v over the whole cache of S slots
    assert port[(mesh, "decode")].totals.matmul_flops == rows * (2 * params + attention)


@pytest.mark.parametrize("kind", KINDS)
def test_collective_bytes_are_the_gloo_ranks(kind, port, gloo, reference):
    """None at (1, 1), as in the reference; at (2, 2) the fake trace's
    bytes of each kind are what the step sends on real ranks: the train
    step, whose residual stream is split over sequence, all-gathers and
    reduce-scatters over ``model`` besides its all-reduces; prefill and
    decode, with a cache, all-reduce only."""
    assert port[((1, 1), kind)].totals.collective_bytes == 0
    assert not reference[f"1x1|{kind}"]["coll"]
    got = port[((2, 2), kind)].totals
    assert dict(got.coll_bytes_by_op) == gloo[kind] and gloo[kind]["all-reduce"] > 0
    want = {"all-reduce", "all-gather", "reduce-scatter"} if kind == "train" else {"all-reduce"}
    assert set(gloo[kind]) == want
    assert port[((2, 2), kind)].seq_shard is (kind == "train")
    assert got.coll_cross_host_bytes == 0  # 4 ranks: one host


# the train step's FLOPs at (2, 2) before the residual stream was split over
# sequence (every model rank then repeated its elementwise work)
WHOLE_STREAM_TRAIN_FLOPS = 116_124_579


def test_the_split_stream_counts_fewer_train_flops(port, reference):
    got = port[((2, 2), "train")].totals.flops
    assert got < WHOLE_STREAM_TRAIN_FLOPS, got
    assert abs(got - reference["2x2|train"]["flops"]) <= FLOP_RTOL * reference["2x2|train"]["flops"]


# ------------------------------------------------------- model_flops_for
@pytest.mark.parametrize("arch,shape", [(a, s) for a, s, _ in cells(include_skipped=True)])
def test_model_flops_for_equals_the_references(arch, shape):
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import get_config as ref_config
    from repro.launch import roofline as ref_roofline

    for smoke in (False, True):
        got = roofline.model_flops_for(get_config(arch, smoke=smoke), SHAPES[shape])
        assert got == ref_roofline.model_flops_for(ref_config(arch, smoke=smoke), REF_SHAPES[shape]) and got > 0


# ------------------------------------------------------ the CLI and table
def test_cli_writes_the_references_keys_and_the_table_reads_them(tmp_path):
    from repro.launch.roofline import Roofline as RefRoofline

    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", ARCH, "--shape", "decode_32k", "--pods", "2",
           "--smoke", "--out", str(tmp_path)]
    r = subprocess.run(cmd, capture_output=True, text=True, env=_env(), timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    path = tmp_path / "smoke" / f"{ARCH}__decode_32k__2pod.json"
    rec = json.loads(path.read_text())
    assert {"arch", "shape", "pods", "chips", "ok", "lower_s", "compile_s", "memory_analysis", "cost_analysis",
            "collectives", "roofline"} <= set(rec)
    assert rec["ok"] and rec["chips"] == 512 and rec["seq_shard"] is False and "no device" in r.stdout
    # a train record at (16, 16): the residual stream split over sequence
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", ARCH, "--shape", "train_4k", "--pods", "1",
           "--smoke", "--out", str(tmp_path / "train")]
    r = subprocess.run(cmd, capture_output=True, text=True, env=_env(), timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    train = json.loads((tmp_path / "train" / "smoke" / f"{ARCH}__train_4k__1pod.json").read_text())
    assert train["ok"] and train["chips"] == 256 and train["seq_shard"] is True
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(train["collectives"]["bytes_by_axis_op"]["model"])
    assert {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes", "peak_bytes_per_device"} <= set(rec["memory_analysis"])
    assert set(RefRoofline(1.0, 1.0, 1.0, 1).to_dict()) <= set(rec["roofline"])
    assert {"flops", "bytes_accessed"} <= set(rec["cost_analysis"]) and {"bytes_by_op", "count_by_op"} <= set(
        rec["collectives"])

    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.roofline", "--pods", "2", "--smoke", "--out",
                        str(tmp_path)], capture_output=True, text=True, env=_env(), timeout=60)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = {tuple(ln.split()[:2]): ln for ln in r.stdout.splitlines()[2:]}
    assert len(lines) == len(cells(include_skipped=True))
    ours = lines[(ARCH, "decode_32k")].split()
    assert ours[2].endswith("ms") and ours[5] == rec["roofline"]["bottleneck"]
    assert lines[(ARCH, "train_4k")].split()[2] == "MISSING" and lines[(ARCH, "long_500k")].split()[2] == "SKIP"


# ------------------------------------------------ one cell a family at (16, 16)
FAMILY_CELLS = {"dense": ("qwen3-14b", "train_4k"), "moe": ("olmoe-1b-7b", "prefill_32k"),
                "mla": ("minicpm3-4b", "decode_32k"), "rwkv6": ("rwkv6-1.6b", "long_500k"),
                "hybrid": ("zamba2-1.2b", "train_4k"), "encdec": ("whisper-small", "prefill_32k")}

FAMILIES = textwrap.dedent("""
    import json, sys
    from repro_torch.launch import dryrun
    for arch, shape in json.loads(sys.argv[1]):
        rec = dryrun.run_cell(arch, shape, 1, smoke=True, root=sys.argv[2])
        print("REC " + json.dumps(rec))
""")


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    r = subprocess.run([sys.executable, "-c", FAMILIES, json.dumps(list(FAMILY_CELLS.values())),
                        str(tmp_path_factory.mktemp("dry"))], capture_output=True, text=True, env=_env(), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    recs = [json.loads(ln[4:]) for ln in r.stdout.splitlines() if ln.startswith("REC ")]
    return {(rec["arch"], rec["shape"]): rec for rec in recs}


@pytest.mark.parametrize("family", list(FAMILY_CELLS))
def test_one_cell_a_family_on_the_production_mesh(family, families):
    """The smoke configs at (16, 16), where ``model`` 16 is wider than
    their 4 heads, 2 KV heads and 4 experts: rank 0's step traces, with
    FLOPs and bytes, collectives over ``model`` crossing hosts (16
    consecutive ranks), and the rules' argument bytes under what rank 0
    holds.  rwkv6's decode has no collective: its blocks have no split,
    and its logits stay split over the vocabulary."""
    rec = families[FAMILY_CELLS[family]]
    assert rec["ok"] and rec["chips"] == 256
    # the one train cell of a family that splits the residual stream over sequence
    assert rec["seq_shard"] is (family == "dense")
    assert rec["cost_analysis"]["flops"] > 0 and rec["cost_analysis"]["bytes_accessed"] > 0
    coll, rl = rec["collectives"], rec["roofline"]
    if family == "rwkv6":
        assert coll["bytes_by_op"] == {} and rl["collective_s"] == 0
    else:
        assert coll["bytes_by_axis"]["model"] > 0 and rl["collective_bytes_per_device"] > 0
    assert rl["collective_ib_bytes_per_device"] == rl["collective_bytes_per_device"]
    mem = rec["memory_analysis"]
    assert 0 < mem["argument_size_in_bytes"] < mem["held_argument_size_in_bytes"]
