"""The port's distributed layer (``repro_torch.distributed``), its mesh
builders, the sharded checkpoint restore and the data-parallel loop, on
gloo ranks on the CPU (``tests/dist_harness.py``), held against the JAX
package run in a subprocess on 4 host devices
(``--xla_force_host_platform_device_count``), on the same numpy inputs.

Tolerances, each with its reason:
- the compressed all-reduce: the int8 payloads and the int32 sums equal;
  the reduced values within 1 f32 ulp (the reference's jitted form
  multiplies by the reciprocal of a constant divisor where the port
  divides);
- gpipe: atol = rtol = 1e-5, tests/test_pipeline.py's (a tanh of f32
  products, summed in another order);
- checkpoints: bit for bit (leaves are stored whole);
- the data-parallel step at 2 ranks against one process, f32: the
  gradient of a mean over 4 rows against the mean of two 2-row gradients,
  summed in another order.  Losses within rtol 1e-5 (atol 1e-6).
  Parameters after three steps within atol = rtol = 1e-4, the f32
  parameter tolerance tests/test_torch_training.py holds the port's step
  to against the reference's: AdamW divides each entry's moment by its
  own second moment, so an entry whose gradient nearly cancels over the
  rows moves by up to the learning rate (3e-4) either way, and its
  difference scales with the step, not with the parameter (one entry of
  16,384 was 2.0e-6 apart at 0.032).
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import dist_harness as dh
from repro.distributed import compression as jax_cmp
from repro_torch.configs import get_config
from repro_torch.distributed import compression as cmp
from repro_torch.distributed.pipeline import pipeline_stage_params
from repro_torch.distributed.sharding import AbstractMesh
from repro_torch.models import api
from repro_torch.models.common import tree_flatten

SRC = Path(__file__).resolve().parents[1] / "src"
GPIPE_TOL = 1e-5
DP_LOSS_RTOL, DP_LOSS_ATOL = 1e-5, 1e-6
DP_PARAM_TOL = 1e-4
# the reference's crash-resume tolerance (tests/test_training.py:118)
RESUME_RTOL, RESUME_ATOL = 1e-5, 1e-6
# the launcher's smoke config is bf16: each model rank's partial product is
# rounded to bf16 (8 significant bits) before the f32 sum over model, a
# rounding one device does not make, so the losses read ~1e-4 apart (8e-5
# at 2 and 4 steps); a quarter of one bf16 step (2^-8) still fails a
# partial dropped or counted twice, which moves the loss by far more
LAUNCH_RTOL = 1e-3

JAX_BEFORE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.experimental.shard_map import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.distributed import compression as cmp
    from repro.distributed.pipeline import gpipe
    from repro.training import checkpoint as ckpt

    inp = dict(np.load(sys.argv[1]))
    out = {}
    auto = jax.sharding.AxisType.Auto
    mesh = jax.make_mesh((4,), ("data",), axis_types=(auto,))

    # allreduce_compressed itself on per-device gradients: each device holds
    # its own (grad, residual), presented as the replicated arrays the
    # reference's shard_map takes (in_specs P())
    def per_device(stack):
        return jax.make_array_from_single_device_arrays(stack.shape[1:], NamedSharding(mesh, P()),
            [jax.device_put(a, d) for a, d in zip(stack, mesh.devices.flat)])

    keys = ("a", "b")
    reduced, new_res = cmp.allreduce_compressed(mesh, {k: per_device(inp["grad_" + k]) for k in keys},
                                                {k: per_device(inp["res_" + k]) for k in keys})
    for k in keys:
        for sh in reduced[k].addressable_shards:
            out[f"reduced_{k}_{sh.device.id}"] = np.asarray(sh.data)
        for sh in new_res[k].addressable_shards:
            out[f"new_res_{k}_{sh.device.id}"] = np.asarray(sh.data)

    # tests/test_compression_e2e.py's shard_map form, on the same per-rank
    # gradients (leaf a, no residual)
    def dp_compressed(g):
        q, s = cmp.quantize_tensor(g[0])
        s_max = jax.lax.pmax(s, "data")
        qr = jnp.round(q.astype(jnp.float32) * (s / s_max))
        qsum = jax.lax.psum(qr.astype(jnp.int32), "data")
        return q[None], s[None], qsum.astype(jnp.float32) * (s_max / 4)

    fn = shard_map(dp_compressed, mesh=mesh, in_specs=(P("data"),), out_specs=(P("data"), P("data"), P()),
                   check_rep=False)
    with mesh:
        q, s, red = jax.jit(fn)(jnp.asarray(inp["grad_a"]))
    out["e2e_q"], out["e2e_s"], out["e2e_reduced"] = np.asarray(q), np.asarray(s), np.asarray(red)

    # gpipe at 4 stages, 6 microbatches (tests/test_pipeline.py)
    smesh = jax.make_mesh((4,), ("stage",), axis_types=(auto,))
    with smesh:
        out["ys"] = np.asarray(jax.jit(gpipe(lambda p, x: jnp.tanh(x @ p), smesh, axis="stage"))(
            jnp.asarray(inp["w"]), jnp.asarray(inp["xs"])))

    # a checkpoint saved from a sharded (2, 2) mesh
    m1 = jax.make_mesh((2, 2), ("data", "model"), axis_types=(auto,) * 2)
    tree = {"w": jax.device_put(jnp.asarray(inp["ckpt_w"]), NamedSharding(m1, P("data", "model"))),
            "b": jax.device_put(jnp.asarray(inp["ckpt_b"], jnp.bfloat16), NamedSharding(m1, P("model")))}
    ckpt.save(sys.argv[3], 3, tree)
    np.savez(sys.argv[2], **out)
    print("JAX_OK")
""")

JAX_AFTER = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.training import checkpoint as ckpt

    inp = dict(np.load(sys.argv[1]))
    m2 = jax.make_mesh((4, 1), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    like = {"w": jnp.zeros((8, 8)), "b": jnp.zeros((8,), jnp.bfloat16)}
    sh2 = {"w": NamedSharding(m2, P("model", "data")), "b": NamedSharding(m2, P("data"))}
    got, manifest = ckpt.restore(sys.argv[2], 3, like, sh2)
    assert manifest["step"] == 3
    np.testing.assert_array_equal(np.asarray(got["w"]), inp["ckpt_w"])
    want_b = np.asarray(jnp.asarray(inp["ckpt_b"], jnp.bfloat16))
    assert got["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got["b"]).view(np.uint16), want_b.view(np.uint16))
    assert got["w"].sharding.is_equivalent_to(sh2["w"], 2) and got["b"].sharding.is_equivalent_to(sh2["b"], 1)
    print("JAX_RESTORE_OK")
""")


def _jax(script, *args):
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", script, *map(str, args)], capture_output=True, text=True, env=env,
                       timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """The JAX package on 4 host devices, then the port on 4 gloo ranks,
    then the JAX package restoring the port's sharded checkpoint."""
    root = tmp_path_factory.mktemp("four")
    inp = dh.inputs()
    np.savez(root / "inputs.npz", **inp)
    jax_ckpt, port_ckpt = root / "ckpt_jax", root / "ckpt_port"
    assert "JAX_OK" in _jax(JAX_BEFORE, root / "inputs.npz", root / "jax_out.npz", jax_ckpt)
    ranks = dh.run_ranks(dh.four_ranks, 4, str(root / "ranks"), inp, str(jax_ckpt), str(port_ckpt))
    after = _jax(JAX_AFTER, root / "inputs.npz", port_ckpt)
    return {"inp": inp, "ref": dict(np.load(root / "jax_out.npz")), "ranks": ranks, "jax_restored": after}


# ------------------------------------------------------------------ place
def test_place_gives_each_rank_the_slice_shard_slices_names(four):
    """Every leaf of qwen3-14b-smoke on (data 2, model 2) and of
    kimi-k2-smoke with ZeRO over (pod, data) on (pod 2, data 2, model 1):
    each rank's local shard is its coordinate's ``shard_slices`` slice,
    and the placements are the sharding's (checked on the ranks)."""
    n = sum(len(tree_flatten(api.param_specs(get_config(a, smoke=True)))[0]) for a in ("qwen3-14b", "kimi-k2-1t-a32b"))
    for out in four["ranks"]:
        assert out["placed_leaves"] == n
        assert out["composite_kimi-k2-1t-a32b"] > 0 and out["composite_qwen3-14b"] == 0


def test_a_dim_over_pod_and_data_splits_pod_major(four):
    """[Shard(0), Shard(0)] over (pod 2, data 2): rank 3 holds rows 6-7 of
    8, as JAX's P(("pod", "data")) does."""
    assert [r["pod_data_rows"] for r in four["ranks"]] == [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0], [6.0, 7.0]]


# ------------------------------------------------- the compressed all-reduce
def _qsum(reduced, s_max, n=4):
    """The int32 sum behind a reduced leaf: reduced = qsum · (s_max / n)."""
    return np.rint(reduced / (s_max / np.float32(n))).astype(np.int64)


def test_compressed_allreduce_matches_the_e2e_scheme(four):
    """tests/test_compression_e2e.py's shard_map form on the same per-rank
    gradients: each rank's int8 payload equal, its scale within 1 ulp
    (the reference's jitted divide by 127 is a reciprocal multiply), the
    int32 sum equal, the reduced gradient within 1 ulp on every rank."""
    ref = four["ref"]
    for r, out in enumerate(four["ranks"]):
        np.testing.assert_array_equal(out["e2e_q"].numpy(), ref["e2e_q"][r])
        np.testing.assert_array_max_ulp(out["e2e_s"].numpy(), ref["e2e_s"][r], maxulp=1)
        got = out["e2e_reduced"].numpy()
        np.testing.assert_array_max_ulp(got, ref["e2e_reduced"], maxulp=1)
        s_max = np.float32(max(float(o["e2e_s"]) for o in four["ranks"]))
        np.testing.assert_array_equal(_qsum(got, s_max), _qsum(ref["e2e_reduced"], ref["e2e_s"].max()))
    # and the mean it approximates: one-step quantization error ~ 1/127
    exact = four["inp"]["grad_a"].mean(0)
    assert np.linalg.norm(got - exact) / np.linalg.norm(exact) < 0.02


def test_allreduce_compressed_matches_the_reference_on_per_rank_gradients(four):
    """``allreduce_compressed`` itself, each rank with its own gradient and
    residual (two leaves, one ragged): the error-feedback quantization per
    rank equal to the reference's ``compress_grads`` (int8 payload and
    scale), the new residuals bit for bit, the int32 sums equal and the
    reduced leaves within 1 ulp, the same on every rank."""
    inp, ref = four["inp"], four["ref"]
    for r, out in enumerate(four["ranks"]):
        for k in dh.GRAD_SHAPES:
            g, e = inp[f"grad_{k}"][r], inp[f"res_{k}"][r]
            q, s, _ = cmp.compress_grads({k: torch.from_numpy(g)}, {k: torch.from_numpy(e)})
            jq, js, _ = jax_cmp.compress_grads({k: g}, {k: e})
            np.testing.assert_array_equal(q[k].numpy(), np.asarray(jq[k]))
            assert float(s[k]) == float(js[k])
            np.testing.assert_array_equal(out["new_res"][k].numpy(), ref[f"new_res_{k}_{r}"])
            got = out["reduced"][k].numpy()
            np.testing.assert_array_max_ulp(got, ref[f"reduced_{k}_{r}"], maxulp=1)
            scales = [float(cmp.compress_grads({k: torch.from_numpy(inp[f"grad_{k}"][i])},
                                               {k: torch.from_numpy(inp[f"res_{k}"][i])})[1][k]) for i in range(4)]
            s_max = np.float32(max(scales))
            np.testing.assert_array_equal(_qsum(got, s_max), _qsum(ref[f"reduced_{k}_{r}"], s_max))
            np.testing.assert_array_equal(got, four["ranks"][0]["reduced"][k].numpy())


def test_allreduce_compressed_without_batch_axes_returns_its_inputs():
    grads, res = {"w": torch.ones(3)}, {"w": torch.zeros(3)}
    out = cmp.allreduce_compressed(AbstractMesh((2,), ("model",)), grads, res)
    assert out[0] is grads and out[1] is res


def test_grad_compression_error_feedback_converges():
    """The reference's test (tests/test_distributed.py), on the port."""
    rng = np.random.default_rng(0)
    g_true = {"w": torch.from_numpy(rng.standard_normal((32, 32)).astype(np.float32))}
    res = cmp.init_residuals(g_true)
    acc = torch.zeros_like(g_true["w"])
    n = 50
    for _ in range(n):
        q, s, res = cmp.compress_grads(g_true, res)
        acc = acc + cmp.dequantize_tensor(q["w"], s["w"])
    # error feedback keeps the long-run mean unbiased
    np.testing.assert_allclose((acc / n).numpy(), g_true["w"].numpy(), atol=0.02)


def test_quantize_tensor_range():
    """The reference's test, on the port; and q, scale equal to the
    reference's on a seeded tensor."""
    x = torch.tensor([[-3.0, 0.0, 3.0]])
    q, s = cmp.quantize_tensor(x)
    assert q.dtype == torch.int8 and int(q.max()) == 127
    np.testing.assert_allclose(cmp.dequantize_tensor(q, s).numpy(), x.numpy(), atol=0.03)
    a = np.random.default_rng(1).standard_normal((64, 33)).astype(np.float32)
    q, s = cmp.quantize_tensor(torch.from_numpy(a))
    jq, js = jax_cmp.quantize_tensor(a)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)


# ------------------------------------------------------------------ gpipe
def test_gpipe_matches_the_reference_and_sequential(four):
    """4 stages, 6 microbatches: every rank's ys against the reference's
    gpipe on 4 host devices and against the stages applied in turn."""
    w, xs = (torch.from_numpy(four["inp"][k]) for k in ("w", "xs"))
    want = dh.sequential(w, xs).numpy()
    for out in four["ranks"]:
        ys = out["ys"].numpy()
        np.testing.assert_allclose(ys, four["ref"]["ys"], rtol=GPIPE_TOL, atol=GPIPE_TOL)
        np.testing.assert_allclose(ys, want, rtol=GPIPE_TOL, atol=GPIPE_TOL)


def test_pipeline_stage_params():
    split = pipeline_stage_params({"w": torch.zeros(8, 3)}, 4)
    assert split["w"].shape == (4, 2, 3)
    with pytest.raises(ValueError, match="layers 6 % stages 4"):
        pipeline_stage_params({"w": torch.zeros(6, 3)}, 4)


# ------------------------------------------------------------ elastic restore
def _bits(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def test_elastic_restore_across_mesh_shapes(four):
    """Saved from a (2, 2) mesh (DTensor leaves, rank 0 writes), restored
    onto (4, 1) with another layout: bit for bit, bf16 kept (the
    placements and local shards are checked on the ranks)."""
    inp = four["inp"]
    for out in four["ranks"]:
        got, step = out["restored"]["own"]
        assert step == 3 and got["b"].dtype == torch.bfloat16
        np.testing.assert_array_equal(got["w"].numpy(), inp["ckpt_w"])
        np.testing.assert_array_equal(_bits(got["b"]), _bits(torch.from_numpy(inp["ckpt_b"]).to(torch.bfloat16)))


def test_port_restores_a_reference_checkpoint_from_a_sharded_mesh(four):
    """The JAX package saved from a sharded (2, 2) host mesh; the port
    restores it onto its (4, 1) mesh bit for bit."""
    want_b = _bits(torch.from_numpy(four["inp"]["ckpt_b"]).to(torch.bfloat16))  # f32 -> bf16 rounds alike in both
    for out in four["ranks"]:
        got, step = out["restored"]["jax"]
        assert step == 3 and got["b"].dtype == torch.bfloat16
        np.testing.assert_array_equal(got["w"].numpy(), four["inp"]["ckpt_w"])
        np.testing.assert_array_equal(_bits(got["b"]), want_b)


def test_reference_restores_a_port_checkpoint_from_a_sharded_mesh(four):
    """The port saved from its sharded (2, 2) mesh; the JAX package
    restores it onto a (4, 1) host mesh bit for bit."""
    assert "JAX_RESTORE_OK" in four["jax_restored"]


# --------------------------------------------------- the data-parallel loop
@pytest.fixture(scope="module")
def two(tmp_path_factory):
    root = tmp_path_factory.mktemp("two")
    ranks = dh.run_ranks(dh.two_ranks, 2, str(root / "ranks"), dh.inputs(), 3, "qwen3-14b", str(root / "ckpt"))
    return ranks, root


def test_data_parallel_step_matches_one_process(two):
    """qwen3-14b-smoke in f32, 3 steps: each of 2 ranks computes its 2 of
    the 4 rows and the gradients are mean-reduced; losses and parameters
    against the same steps in one process over all 4 rows."""
    ranks, _ = two
    params, losses = dh.dp_steps(get_config("qwen3-14b", smoke=True), 3)
    for out in ranks:
        np.testing.assert_allclose(out["losses"], losses, rtol=DP_LOSS_RTOL, atol=DP_LOSS_ATOL)
        for got, want in zip(tree_flatten(out["params"])[0], tree_flatten(params)[0]):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=DP_PARAM_TOL, atol=DP_PARAM_TOL)
    assert ranks[0]["losses"] == ranks[1]["losses"]


def test_gpipe_at_one_stage_is_the_stage_function(two):
    for out in two[0]:
        np.testing.assert_allclose(out["one_stage"].numpy(), out["one_stage_want"].numpy(), rtol=0, atol=0)


def test_data_parallel_loop_resumes_its_own_trajectory(two):
    """The loop under a (data 2) mesh crashed after step 3 (checkpoints
    every 2) and resumed from step 2, the checkpoint restored under the
    ZeRO shardings of the parameters and state (``train(shardings=)``,
    then gathered whole for the data-parallel step): its losses replay
    the uninterrupted run's, the same on both ranks; every step was
    committed once."""
    ranks, _ = two
    for out in ranks:
        assert out["sharded_leaves"] > 20
        loop = out["loop"]
        assert loop["crashed"] and loop["resumed_from"] == 2 and len(loop["resumed"]) == 4
        np.testing.assert_allclose(loop["resumed"], loop["full"][2:], rtol=RESUME_RTOL, atol=RESUME_ATOL)
        assert loop["files"] == ["step_000000002", "step_000000004", "step_000000006"]
    assert ranks[0]["loop"] == ranks[1]["loop"]


# ------------------------------------------------------ launcher and meshes
def test_launcher_model_2_runs(tmp_path):
    """``launch.train.main --data 1 --model 2`` on 2 gloo ranks: the
    smoke config (bf16) trains 2 steps tensor-parallel, with the losses of
    the ``--model 1`` run in one process within LAUNCH_RTOL, the same on
    both ranks."""
    from repro_torch.launch.train import main

    argv = ["--device", "cpu", "--steps", "2", "--ckpt-every", "5"]
    ranks = dh.run_ranks(dh.launcher_ranks, 2, str(tmp_path / "ranks"), argv + ["--data", "1", "--model", "2"])
    one = main(argv + ["--ckpt-dir", str(tmp_path / "one")])
    assert ranks[0]["losses"] == ranks[1]["losses"] and len(one["losses"]) == 2
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], rtol=LAUNCH_RTOL, atol=0)


@pytest.mark.parametrize("world,data,model,want", [
    (4, None, None, (2, 2)),  # the reference's defaults, where the world allows them
    (1, None, None, (1, 1)),
    (2, None, None, (2, 1)),
    (8, None, None, (8, 1)),
    (2, None, 2, (1, 2)),
    (4, 4, None, (4, 1)),
    (2, 1, 2, (1, 2)),
])
def test_launcher_mesh_shape(world, data, model, want):
    from repro_torch.launch.train import mesh_shape

    assert mesh_shape(world, data, model) == want


def test_launcher_keeps_the_references_unused_flags(tmp_path, monkeypatch):
    """Two quirks of the reference's launcher (src/repro/launch/train.py),
    kept: ``--compress-grads`` is parsed and never read (the same losses
    with it, bit for bit), and the parameter shardings are computed and
    never used (``param_shardings`` called once, on the launcher's mesh;
    the loop gets no shardings)."""
    from repro_torch.launch import train as launcher

    calls, seen = [], []
    orig_shardings, orig_train = launcher.shd.param_shardings, launcher.train
    monkeypatch.setattr(launcher.shd, "param_shardings", lambda mesh, specs: calls.append(mesh) or
                        orig_shardings(mesh, specs))
    monkeypatch.setattr(launcher, "train", lambda *a, **kw: seen.append(kw) or orig_train(*a, **kw))
    argv = ["--device", "cpu", "--steps", "2", "--ckpt-every", "5"]
    plain = launcher.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    compressed = launcher.main(argv + ["--ckpt-dir", str(tmp_path / "b"), "--compress-grads"])
    assert plain["losses"] == compressed["losses"]
    assert len(calls) == 2 and all(dict(zip(m.mesh_dim_names, m.shape)) == {"data": 1, "model": 1} for m in calls)
    assert all("shardings" not in kw and kw["mesh"] is not None for kw in seen)


def test_mesh_builders_check_the_world_size():
    import torch.distributed as dist

    from repro_torch.launch import mesh

    with pytest.raises(RuntimeError, match="needs a process group"):
        mesh.make_smoke_mesh(1, 1, device="cpu")
    assert mesh.init_process_group("cpu")
    try:
        assert not mesh.init_process_group("cpu")  # one is open
        m = mesh.make_smoke_mesh(1, 1, device="cpu")
        assert m.mesh_dim_names == ("data", "model") and m.shape == (1, 1)
        assert mesh.make_smoke_mesh(1, 1, pod=1, device="cpu").mesh_dim_names == ("pod", "data", "model")
        with pytest.raises(ValueError, match=r"\{'data': 2, 'model': 2\} has 4 devices.*world size 1"):
            mesh.make_smoke_mesh(2, 2, device="cpu")
        with pytest.raises(ValueError, match="256 devices.*world size 1"):
            mesh.make_production_mesh(device="cpu")
        with pytest.raises(ValueError, match=r"\{'pod': 2, 'data': 16, 'model': 16\} has 512"):
            mesh.make_production_mesh(multi_pod=True, device="cpu")
    finally:
        dist.destroy_process_group()
