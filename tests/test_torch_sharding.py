"""The port's sharding rules (``repro_torch.distributed.sharding``) and the
step builders' shardings (``repro_torch.launch.steps``) against the
reference's, with no process group: the port runs on ``AbstractMesh``es.

- The reference's rule tests (tests/test_distributed.py), mirrored.
- The reference's pure rules (``param_spec_for``, ``cache_spec_for``,
  ``filter_spec``) on its FakeMesh against the port's, leaf by leaf.
- The reference's ``train_shardings`` (both moment modes),
  ``prefill_shardings`` and ``decode_shardings`` on real host meshes of
  (2, 2), (16, 16) and (2, 16, 16) devices, in a subprocess, against the
  port's: every spec equal.
- ``shard_slices`` against JAX's ``devices_indices_map`` on (2, 2) and
  (2, 2, 2) host meshes, for every leaf of the smoke configs, compared by
  mesh coordinate.

Specs are compared exactly (as tuples of entries), slices as (start, stop)
pairs: the rules are integer arithmetic, so no tolerance applies.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as jax_shd
from repro.models import api as jax_api
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import P, AbstractMesh, NamedSharding
from repro_torch.launch import steps
from repro_torch.models import api
from repro_torch.training import optim

SRC = Path(__file__).resolve().parents[1] / "src"

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SLICE_MESHES = {"2x2": ((2, 2), ("data", "model")), "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
FULL = ["qwen3-14b", "olmoe-1b-7b", "minicpm3-4b", "whisper-small"]
CONFIGS = [(a, True) for a in ARCH_IDS] + [(a, False) for a in FULL]
CONFIG_IDS = [f"{a}-{'smoke' if s else 'full'}" for a, s in CONFIGS]
# cells small enough for every config; S a multiple of the decode page, so
# the port's cache shapes are the reference's
TRAIN, PREFILL, DECODE = (ShapeConfig("train", 64, 8, "train"), ShapeConfig("prefill", 64, 8, "prefill"),
                          ShapeConfig("decode", 64, 8, "decode"))
OPTIMIZERS = {"f32": dict(), "lean": dict(moment_dtype="bfloat16", factored_second_moment=True)}


class FakeMesh:
    """The reference tests' duck-typed mesh (tests/test_distributed.py:17)."""

    def __init__(self, axes):
        self.axis_names = tuple(axes)
        self._shape = tuple(axes.values())

    @property
    def devices(self):
        return np.empty(self._shape, dtype=object)


def spec_json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


# ------------------------------------------------- the reference's rule tests
def test_param_spec_rules():
    fs = ("data",)
    assert shd.param_spec_for("embed", 2, False, fs) == P("model", "data")
    assert shd.param_spec_for("lm_head", 2, False, fs) == P("data", "model")
    assert shd.param_spec_for("blocks/attn/wq", 3, True, fs) == P(None, "data", "model")
    assert shd.param_spec_for("blocks/attn/wo", 3, True, fs) == P(None, "model", "data")
    assert shd.param_spec_for("blocks/moe/w_gate", 4, True, fs) == P(None, "model", "data", None)
    assert shd.param_spec_for("blocks/mlp/w_down", 3, True, fs) == P(None, "model", "data")
    assert shd.param_spec_for("blocks/attn_norm", 2, True, fs) == P()  # replicated
    # multi-axis fsdp (kimi-k2 ZeRO over pod+data)
    spec = shd.param_spec_for("blocks/moe/w_gate", 4, True, ("pod", "data"))
    assert spec == P(None, "model", ("pod", "data"), None)


def test_filter_spec_drops_missing_and_indivisible():
    mesh = AbstractMesh((4, 8), ("data", "model"))
    assert shd.filter_spec(P("pod", "model"), mesh) == P(None, "model")
    # 10 % 8 != 0 -> model dropped from that dim
    assert shd.filter_spec(P("data", "model"), mesh, (8, 10)) == P("data", None)
    # composite axes keep the dividing prefix
    assert shd.filter_spec(P(("data", "model"),), mesh, (4,)) == P("data")


def test_cache_sharding_never_seq_for_attn():
    # kvh divides TP -> head sharding
    spec, _ = shd.cache_spec_for("k", (4, 16, 128, 8, 64), model=8)
    assert spec[3] == "model" and spec[2] is None
    # kvh doesn't divide -> head-dim (contraction) sharding, never seq
    spec, _ = shd.cache_spec_for("v", (4, 16, 128, 2, 64), model=8)
    assert spec[3] is None and spec[4] == "model" and spec[2] is None
    # MLA latent prefers the latent dim (same seq-DUS hazard)
    spec, _ = shd.cache_spec_for("c", (4, 16, 128, 32), model=8)
    assert spec[3] == "model" and spec[2] is None
    spec, _ = shd.cache_spec_for("c", (4, 16, 128, 30), model=8)
    assert spec[2] == "model"  # fallback when latent doesn't divide


# ------------------------------------------- the port's mesh and spec types
def test_named_sharding_placements_and_slices():
    """A dim over (pod, data) is Shard on both mesh dims, split pod-major:
    on a (2, 2) mesh the coordinate (1, 1) holds rows 6-7 of 8."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = AbstractMesh((2, 2), ("pod", "data"))
    sh = NamedSharding(mesh, P(("pod", "data"), None))
    assert sh.placements() == [Shard(0), Shard(0)]
    assert sh.shard_slices((8, 3))[(1, 1)] == (slice(6, 8), slice(0, 3))
    assert sh.shard_slices((8, 3))[(1, 0)] == (slice(4, 6), slice(0, 3))
    assert NamedSharding(AbstractMesh((2, 2), ("data", "model")), P(None, "model")).placements() == \
        [Replicate(), Shard(1)]
    assert NamedSharding(mesh, P()).shard_slices((5,)) == {c: (slice(0, 5),) for c in sh.shard_slices((8, 3))}


@pytest.mark.parametrize("spec, error", [
    (P(("data", "pod")), "not in mesh order"),  # DTensor cannot split a dim minor-axis first
    (P("data", "data"), "two dims"),
    (P("model"), "not on the mesh"),
])
def test_named_sharding_refuses_what_dtensor_cannot_express(spec, error):
    with pytest.raises(ValueError, match=error):
        NamedSharding(AbstractMesh((2, 2), ("pod", "data")), spec)


def test_shard_slices_refuses_uneven_splits():
    with pytest.raises(ValueError, match="does not split"):
        NamedSharding(AbstractMesh((4,), ("data",)), P("data")).shard_slices((6,))


def test_meta_specs_have_the_references_shapes_and_dtypes():
    """``api.param_specs``, ``input_specs`` (with the cache) and
    ``optim.state_specs`` are meta tensors with the reference's shapes and
    dtypes, leaf for leaf."""
    import jax

    from repro.training import optim as jax_optim

    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch, smoke=True), jax_get_config(arch, smoke=True)
        p, jp = api.param_specs(cfg), jax_api.param_specs(jcfg)
        for kw in OPTIMIZERS.values():
            trees = [(p, jp), (optim.state_specs(optim.OptimizerConfig(**kw), p),
                               jax_optim.state_specs(jax_optim.OptimizerConfig(**kw), jp))]
            trees += [(api.input_specs(cfg, s), jax_api.input_specs(jcfg, s)) for s in (TRAIN, PREFILL, DECODE)]
            for mine, ref in trees:
                got = [(tuple(t.shape), str(t.dtype).split(".")[-1], t.device.type) for t in _leaves(mine)]
                want = [(tuple(s.shape), str(s.dtype), "meta") for s in jax.tree.leaves(ref)]
                assert got == want, arch


def _leaves(tree):
    from repro_torch.models.common import tree_leaves

    return tree_leaves(tree)


# ------------------------------- the reference's pure rules on the FakeMesh
def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _paths(tree[k], prefix + (k,))]
    return [(prefix, tree)]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch, smoke", CONFIGS, ids=CONFIG_IDS)
def test_rules_match_the_references_on_the_fake_mesh(arch, smoke, mesh_name):
    """Every param leaf (both fsdp axis sets) and every cache leaf: the
    reference's param_spec_for / cache_spec_for then filter_spec on its
    FakeMesh, against the port's on an AbstractMesh of the same axes."""
    shape, names = MESHES[mesh_name]
    fake, mesh = FakeMesh(dict(zip(names, shape))), AbstractMesh(shape, names)
    cfg = get_config(arch, smoke=smoke)
    for fsdp in (("data",), ("pod", "data")):
        for path, leaf in _paths(api.param_specs(cfg)):
            ps = "/".join(path)
            stacked = "blocks" in ps
            want = jax_shd.filter_spec(jax_shd.param_spec_for(ps, leaf.dim(), stacked, fsdp), fake, tuple(leaf.shape))
            got = shd.filter_spec(shd.param_spec_for(ps, leaf.dim(), stacked, fsdp), mesh, tuple(leaf.shape))
            assert tuple(got) == tuple(want), ps
    model = dict(zip(names, shape))["model"]
    for path, leaf in _paths(api.cache_specs(cfg, 8, 64)):
        want, wshape = jax_shd.cache_spec_for(path[-1], tuple(leaf.shape), model)
        got, gshape = shd.cache_spec_for(path[-1], tuple(leaf.shape), model)
        assert tuple(shd.filter_spec(got, mesh, gshape)) == tuple(jax_shd.filter_spec(want, fake, wshape)), path


# ------------------- the reference's step shardings on real host meshes
REFERENCE_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax, numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_config
    from repro.configs.base import ShapeConfig
    from repro.distributed import sharding as shd
    from repro.launch import steps
    from repro.models import api
    from repro.training import optim

    meshes, slice_meshes, configs, optimizers = json.loads(sys.argv[1])
    TRAIN, PREFILL, DECODE = (ShapeConfig("train", 64, 8, "train"), ShapeConfig("prefill", 64, 8, "prefill"),
                              ShapeConfig("decode", 64, 8, "decode"))

    def mesh_of(shape, names):
        n = int(np.prod(shape))
        return Mesh(np.array(jax.devices()[:n]).reshape(shape), tuple(names))

    def spec_json(spec):
        return [list(e) if isinstance(e, tuple) else e for e in spec]

    def specs(tree):
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        return {shd._path_str(p): spec_json(s.spec) for p, s in leaves}

    def slices(mesh, sh_tree, like):
        out = {}
        for (p, s), x in zip(jax.tree_util.tree_flatten_with_path(sh_tree)[0], jax.tree.leaves(like)):
            by_coord = {}
            for dev, idx in s.devices_indices_map(tuple(x.shape)).items():
                coord = ",".join(str(int(c)) for c in np.argwhere(mesh.devices == dev)[0])
                by_coord[coord] = [list(sl.indices(n)[:2]) for sl, n in zip(idx, x.shape)]
            out[shd._path_str(p)] = by_coord
        return out

    out = {"specs": {}, "slices": {}}
    for arch, smoke in configs:
        cfg = get_config(arch, smoke=smoke)
        key = f"{arch}-{'smoke' if smoke else 'full'}"
        for mname, (shape, names) in meshes.items():
            mesh = mesh_of(shape, names)
            cell = {}
            for oname, kw in optimizers.items():
                ocfg = optim.OptimizerConfig(**kw)
                (p, o, b), _ = steps.train_shardings(mesh, steps._train_cfg(cfg), TRAIN, ocfg)
                cell["train_" + oname] = {"params": specs(p), "opt": specs(o), "batch": specs(b)}
            (p, i), (lg, c) = steps.prefill_shardings(mesh, cfg, PREFILL)
            cell["prefill"] = {"inputs": specs(i), "logits": specs(lg), "cache": specs(c)}
            (p, t, c, pos), (lg, _) = steps.decode_shardings(mesh, cfg, DECODE)
            cell["decode"] = {"tokens": specs(t), "cache": specs(c), "pos": specs(pos), "logits": specs(lg)}
            out["specs"][f"{key}@{mname}"] = cell
        if not smoke:
            continue
        for mname, (shape, names) in slice_meshes.items():
            mesh = mesh_of(shape, names)
            ocfg = optim.OptimizerConfig(**optimizers["lean"])
            p_specs, o_specs, in_specs = steps.train_abstract_inputs(cfg, TRAIN, ocfg)
            (p, o, b), _ = steps.train_shardings(mesh, cfg, TRAIN, ocfg)
            c_specs = api.cache_specs(cfg, 8, 64)
            c = shd.cache_shardings(mesh, c_specs, cfg)
            out["slices"][f"{key}@{mname}"] = {"params": slices(mesh, p, p_specs), "opt": slices(mesh, o, o_specs),
                                               "batch": slices(mesh, b, in_specs), "cache": slices(mesh, c, c_specs)}
    with open(sys.argv[2], "w") as f:
        json.dump(out, f)
    print("REF_OK")
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("shardings") / "reference.json"
    arg = json.dumps([MESHES, SLICE_MESHES, CONFIGS, OPTIMIZERS])
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REFERENCE_SCRIPT, arg, str(path)], capture_output=True, text=True,
                       env=env, timeout=240)
    assert "REF_OK" in r.stdout, r.stderr[-3000:]
    return json.loads(path.read_text())


def _specs(tree):
    return {"/".join(p): spec_json(s.spec) for p, s in _paths(tree) if s is not None}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch, smoke", CONFIGS, ids=CONFIG_IDS)
def test_step_shardings_match_the_references(reference, arch, smoke, mesh_name):
    """train_shardings (f32 moments, and bf16 m with a factored v),
    prefill_shardings and decode_shardings: the spec of every leaf of the
    params, optimizer state, batch, inputs, cache, logits and pos equals
    the reference's on a real host mesh of the same shape."""
    shape, names = MESHES[mesh_name]
    mesh = AbstractMesh(shape, names)
    cfg = get_config(arch, smoke=smoke)
    cell = {}
    for oname, kw in OPTIMIZERS.items():
        (p, o, b), (p2, o2, metrics) = steps.train_shardings(mesh, steps._train_cfg(cfg), TRAIN,
                                                             optim.OptimizerConfig(**kw))
        assert p2 is p and o2 is o and metrics is None
        cell["train_" + oname] = {"params": _specs(p), "opt": _specs(o), "batch": _specs(b)}
    (p, i), (lg, c) = steps.prefill_shardings(mesh, cfg, PREFILL)
    cell["prefill"] = {"inputs": _specs(i), "logits": _specs(lg), "cache": _specs(c)}
    (p, t, c, pos), (lg, c2) = steps.decode_shardings(mesh, cfg, DECODE)
    assert c2 is c
    cell["decode"] = {"tokens": _specs(t), "cache": _specs(c), "pos": _specs(pos), "logits": _specs(lg)}
    want = reference["specs"][f"{arch}-{'smoke' if smoke else 'full'}@{mesh_name}"]
    assert cell == want


@pytest.mark.parametrize("mesh_name", list(SLICE_MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shard_slices_match_devices_indices_map(reference, arch, mesh_name):
    """For every leaf of the params, the optimizer state (bf16 m, factored
    v), the train batch and the cache of each smoke config: the slices
    ``shard_slices`` gives each mesh coordinate equal those JAX's
    ``NamedSharding.devices_indices_map`` gives the device there."""
    shape, names = SLICE_MESHES[mesh_name]
    mesh = AbstractMesh(shape, names)
    cfg = get_config(arch, smoke=True)
    ocfg = optim.OptimizerConfig(**OPTIMIZERS["lean"])
    p_specs, o_specs, in_specs = steps.train_abstract_inputs(cfg, TRAIN, ocfg)
    (p, o, b), _ = steps.train_shardings(mesh, cfg, TRAIN, ocfg)
    c_specs = api.cache_specs(cfg, 8, 64)
    c = shd.cache_shardings(mesh, c_specs, cfg)
    want = reference["slices"][f"{arch}-smoke@{mesh_name}"]
    for name, sh_tree, like in (("params", p, p_specs), ("opt", o, o_specs), ("batch", b, in_specs),
                                ("cache", c, c_specs)):
        got = {}
        for (path, sh), (_, x) in zip(_paths(sh_tree), _paths(like)):
            got["/".join(path)] = {",".join(map(str, coord)): [[s.start, s.stop] for s in sl]
                                   for coord, sl in sh.shard_slices(tuple(x.shape)).items()}
        assert got == want[name], name


def test_reference_partition_specs_compare_as_tuples():
    """The comparison above is exact: JAX's PartitionSpec keeps trailing
    Nones and composite entries as tuples, as the port's P does."""
    assert tuple(JP("a", None)) == tuple(P("a", None)) and tuple(JP("a", None)) != tuple(P("a"))
    assert tuple(JP(("a", "b"), None)) == tuple(P(("a", "b"), None))
