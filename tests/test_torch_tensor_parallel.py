"""Tensor parallelism over ``model`` (``repro_torch.models.common.tensor_parallel``
and the splits at the reference's constrain sites), the train step under a
(data, model) mesh, the cached forward (prefill and greedy decode) under
``model``, splits wider than their dim, and moe's balance term over the
global batch, on gloo
ranks on the CPU (``tests/dist_harness.py``), held against the same step
in one process and against the JAX package's jitted ``value_and_grad``
under its (2, 2) host mesh, in f32, on the same seeded inputs.

Tolerances (``tests/test_torch_distributed.py``'s data-parallel case),
each with its reason: the splits sum each rank's partial products over
``model`` and the loss's sums of exponentials over the split vocabulary,
in another order than one device's single products, so f32 results differ
in summation order only.  Losses within rtol 1e-5 (atol 1e-6); the cached
forward's logits and f32 caches within atol = rtol 1e-5 (an entry near
zero carries the summation noise of its terms, which are of order 1: one
qwen3-smoke logit of 0.0175 read 1.5e-6 apart); gradients and the
parameters after three steps within atol = rtol 1e-4.

The three steps run AdamW at eps 1e-6 (``dist_harness.TP_EPS``), not the
default 1e-8.  AdamW's first step moves an entry by lr·g/(|g| + eps): at
eps 1e-8 an entry whose gradient is within the f32 summation noise
(~1e-6 of the largest gradient) of zero moves by up to the learning rate
(3e-4) either way, and the parameter check would read that noise rather
than the step (the qkv-bias case's embedding: one entry's gradient
8.3e-8 against 1.1e-8 moved it 1.36e-4 apart).  At 1e-6 that is bounded
by lr·1e-7/1e-6 = 3e-5; the entries read 0.8-5.6e-6 apart.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import dist_harness as dh
from repro_torch.distributed import sharding as shd
from repro_torch.models import api, common, transformer
from repro_torch.models.common import tree_flatten

SRC = Path(__file__).resolve().parents[1] / "src"
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
TOL = 1e-4
CACHED_TOL = 1e-5
STEPS = 3
CASES = list(dh.TP_CASES)
SHAPES = [(1, 2), (2, 2)]
JAX_CASES = ("dense", "moe", "mla")
# splits wider than their dim at model 4: rank 3 holds no KV head
# (dense_uneven: KVH 3, G 1), no query group (dense_groups: KVH 2, G 3) or
# no expert (moe_uneven: 3 experts; ranks 2 and 3 no KV head); whisper's
# ranks 2 and 3 hold no KV head of self- or cross-attention (KVH 2, G 2)
WIDE = ("dense_uneven", "dense_groups", "moe_uneven", "whisper")
# the cached forward under model 2, one case a family
CACHED = ("dense", "moe", "mla", "hybrid", "rwkv6", "whisper")
CACHED_SHAPES = [((1, 2), c) for c in CACHED] + [((1, 4), c) for c in WIDE]

JAX_TP = textwrap.dedent("""
    import os, sys, json, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config
    from repro.launch.mesh import make_smoke_mesh
    from repro.models import api

    inp = dict(np.load(sys.argv[1]))
    cases = json.loads(sys.argv[3])
    out = {}

    def nest(flat):
        tree = {}
        for path, a in flat.items():
            *head, last = path.split("/")
            d = tree
            for k in head:
                d = d.setdefault(k, {})
            d[last] = jnp.asarray(a)
        return tree

    mesh = make_smoke_mesh(2, 2)
    with mesh:
        for case, (arch, over) in cases.items():
            cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
            pre = case + "|p|"
            params = nest({k[len(pre):]: v for k, v in inp.items() if k.startswith(pre)})
            batch = {k: jnp.asarray(inp[f"{case}|b|{k}"]) for k in ("tokens", "labels")}
            fn = jax.jit(jax.value_and_grad(api.loss_fn(cfg), has_aux=True))
            # the constrain sites are live: the lowered step carries shardings
            assert "sharding" in fn.lower(params, batch).as_text()
            (loss, parts), grads = fn(params, batch)
            out[f"{case}|loss"], out[f"{case}|aux"] = np.asarray(loss), np.asarray(parts["aux"])
            for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
                out[f"{case}|g|" + "/".join(k.key for k in path)] = np.asarray(g)
    np.savez(sys.argv[2], **out)
    print("JAX_OK")
""")


def _paths(tree, prefix=""):
    """'/'-joined key paths in ``tree_flatten`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


@pytest.fixture(scope="module")
def one():
    """Every case in one process."""
    return {c: dh.grads_and_steps(dh.tp_config(c), STEPS) for c in CASES}


@pytest.fixture(scope="module")
def one_cached():
    """The cached forward of every cached case in one process."""
    return {c: dh.cached_forward(dh.tp_config(c)) for c in CACHED + WIDE}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case at (data, model) = (1, 2) and moe at (2, 1), and the
    cached forward of CACHED at (1, 2), on 2 gloo ranks; every case at
    (2, 2), and WIDE's steps and cached forward at (1, 4), on 4;
    {(data, model, case[, "cached"]): [per rank]}."""
    root = tmp_path_factory.mktemp("tp")
    two = dh.run_ranks(dh.tp_ranks, 2, str(root / "two"), {(1, 2): CASES, (2, 1): ["moe"]}, STEPS,
                       {(1, 2): CACHED})
    four = dh.run_ranks(dh.tp_ranks, 4, str(root / "four"), {(2, 2): CASES, (1, 4): WIDE}, STEPS, {(1, 4): WIDE})
    return {key: [r[key] for r in rs] for rs in (two, four) for key in rs[0]}


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's jitted value_and_grad of the loss under
    ``make_smoke_mesh(2, 2)`` on 4 host devices, at the port's f32
    parameters and batch, for the dense, moe and MLA cases."""
    root = tmp_path_factory.mktemp("tp_jax")
    inp = {}
    for case in JAX_CASES:
        cfg = dh.tp_config(case)
        params = dh.f32_params(cfg)
        for path, leaf in zip(_paths(params), tree_flatten(params)[0]):
            inp[f"{case}|p|{path}"] = leaf.numpy()
        for k, v in dh.train_batch(cfg, 0).items():
            inp[f"{case}|b|{k}"] = v.numpy().astype(np.int32)
    np.savez(root / "inputs.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", JAX_TP, str(root / "inputs.npz"), str(root / "out.npz"),
                        json.dumps({c: dh.TP_CASES[c] for c in JAX_CASES})],
                       capture_output=True, text=True, env=env, timeout=240)
    assert r.returncode == 0 and "JAX_OK" in r.stdout, r.stderr[-3000:]
    return dict(np.load(root / "out.npz"))


def _close(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL, atol=TOL, err_msg=f"{what} leaf {i}")


# ------------------------------------------------- against one process
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"data{s[0]}_model{s[1]}")
@pytest.mark.parametrize("case", CASES)
def test_loss_and_gradients_equal_one_process(case, shape, ranks, one):
    """Each rank's loss, balance term and every gradient leaf (summed over
    ``model`` where the splits leave them partial, then mean-reduced over
    ``data``) against one process over the whole batch."""
    want = one[case]
    for got in ranks[shape + (case,)]:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL, atol=LOSS_ATOL)
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=LOSS_RTOL, atol=LOSS_ATOL)
        assert len(got["grads"]) == len(want["grads"])
        _close(got["grads"], want["grads"], case)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"data{s[0]}_model{s[1]}")
@pytest.mark.parametrize("case", CASES)
def test_three_steps_equal_one_process(case, shape, ranks, one):
    """The losses of three train steps and the parameters after them
    against one process; every rank ends with the same parameters."""
    want = one[case]
    outs = ranks[shape + (case,)]
    for got in outs:
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL, atol=LOSS_ATOL)
        _close(tree_flatten(got["params"])[0], tree_flatten(want["params"])[0], case)
    for got in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(tree_flatten(got["params"])[0],
                                                     tree_flatten(outs[0]["params"])[0]))


@pytest.mark.parametrize("case", WIDE)
def test_a_split_wider_than_its_dim_equals_one_process(case, ranks, one):
    """At (1, 4) a rank's part of a split is empty (``common.split_range``):
    its attention, MLP or experts add zero to the sum over ``model``, and
    the loss, the gradients and three steps are one process's."""
    want = one[case]
    for got in ranks[(1, 4, case)]:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL, atol=LOSS_ATOL)
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=LOSS_RTOL, atol=LOSS_ATOL)
        _close(got["grads"], want["grads"], case)
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL, atol=LOSS_ATOL)
        _close(tree_flatten(got["params"])[0], tree_flatten(want["params"])[0], case)


# ------------------------------------------------ the cached forward
@pytest.mark.parametrize("shape,case", CACHED_SHAPES, ids=[f"{c}_model{s[1]}" for s, c in CACHED_SHAPES])
def test_cached_forward_equals_one_process(shape, case, ranks, one_cached):
    """Prefill, then two greedy decode steps, with an f32 cache under
    ``model``: each rank's whole logits (its vocabulary columns gathered)
    and greedy tokens are one process's, and so is its cache: the view of
    its KV heads of each GQA leaf (the rest of a leaf it does not write),
    every other leaf (MLA's latent, the recurrent states) whole.  The
    ranks' KV heads cover every head."""
    want = one_cached[case]
    outs = ranks[shape + (case, "cached")]
    heads = set()
    for got in outs:
        for a, b in zip(got["logits"], want["logits"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=CACHED_TOL, atol=CACHED_TOL)
        assert all(torch.equal(a, b) for a, b in zip(got["tokens"], want["tokens"]))
        lo, hi = got["kv_heads"]
        heads |= set(range(lo, hi))
        for name, leaf in got["cache"].items():
            ref = want["cache"][name]
            if name in shd._ATTN_CACHE:
                leaf, ref = leaf[:, :, :, lo:hi], ref[:, :, :, lo:hi]
            np.testing.assert_allclose(leaf.numpy(), ref.numpy(), rtol=CACHED_TOL, atol=CACHED_TOL, err_msg=name)
    assert heads == set(range(dh.tp_config(case).n_kv_heads))


# --------------------------------------------- against the JAX package
@pytest.mark.parametrize("case", JAX_CASES)
def test_loss_and_gradients_equal_the_reference_under_its_mesh(case, ranks, jax_ref):
    """(2, 2) on 4 gloo ranks against the reference's jitted
    ``value_and_grad`` under ``make_smoke_mesh(2, 2)`` (its constrain sites
    live) on 4 JAX host devices, the same f32 parameters and batch."""
    cfg = dh.tp_config(case)
    paths = _paths(api.param_specs(cfg))
    for got in ranks[(2, 2, case)]:
        np.testing.assert_allclose(got["loss"], jax_ref[f"{case}|loss"], rtol=LOSS_RTOL, atol=LOSS_ATOL)
        np.testing.assert_allclose(got["aux"], jax_ref[f"{case}|aux"], rtol=LOSS_RTOL, atol=LOSS_ATOL)
        _close(got["grads"], [jax_ref[f"{case}|g|{p}"] for p in paths], case)


# ------------------------------ moe's balance term under data parallelism
def test_data_parallel_moe_balance_term_is_the_global_batchs(ranks, one):
    """olmoe-smoke at data 2 (model 1): the loss, the balance term and
    every gradient equal one process's over all 4 rows.  The reduction
    the step had before, the mean over ranks of each rank's term over its
    own 2 rows, fails here: its term is 1.7e-3 above the global batch's
    2.0003 (the tolerance is 2.1e-5), and the router's gradient reads
    1.8e-4 apart."""
    want = one["moe"]
    for got in ranks[(2, 1, "moe")]:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL, atol=LOSS_ATOL)
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=LOSS_RTOL, atol=LOSS_ATOL)
        _close(got["grads"], want["grads"], "moe data 2")
    cfg, params = dh.tp_config("moe"), dh.f32_params(dh.tp_config("moe"))
    batch = dh.train_batch(cfg, 0)
    with torch.no_grad():
        per_rank = [float(transformer.lm_loss(params, cfg, {k: v[r * 2:(r + 1) * 2] for k, v in batch.items()})[1]["aux"])
                    for r in range(2)]
    old = sum(per_rank) / 2
    assert abs(old - want["aux"]) > 10 * (LOSS_ATOL + LOSS_RTOL * abs(want["aux"])), (old, want["aux"])


# ------------------------------------------------------------ the rules
def test_model_partial_follows_the_rules_and_the_sites():
    """The leaves whose gradients the step sums over ``model``: those the
    rules split over ``model`` at a constrain site, whatever divides;
    never the embedding, rwkv6's or the Mamba-2 blocks' leaves, or the
    leaves the rules keep whole."""
    def flags(case):
        specs = api.param_specs(dh.tp_config(case))
        return dict(zip(_paths(specs), shd.model_partial_leaves(specs)))

    dense = flags("dense")
    assert {p for p, f in dense.items() if f} == {
        "lm_head", "blocks/attn/wq", "blocks/attn/wk", "blocks/attn/wv", "blocks/attn/wo",
        "blocks/mlp/w_gate", "blocks/mlp/w_up", "blocks/mlp/w_down"}
    assert not dense["embed"] and not dense["blocks/attn/q_norm"]
    moe, mla, bias = flags("moe"), flags("mla"), flags("bias")
    assert moe["blocks/moe/w_gate"] and moe["blocks/moe/w_down"] and not moe["blocks/moe/router"]
    assert mla["blocks/attn/wq_b"] and mla["blocks/attn/wk_b"] and mla["blocks/attn/wv_b"]
    assert not (mla["blocks/attn/wq_a"] or mla["blocks/attn/wkv_a"] or mla["blocks/attn/kv_a_norm"])
    assert bias["blocks/attn/bq"] and bias["blocks/attn/bk"]
    rwkv6, hybrid = flags("rwkv6"), flags("hybrid")
    assert [p for p, f in rwkv6.items() if f] == ["lm_head"]
    assert {p for p, f in hybrid.items() if f} == {
        "lm_head", "shared_attn/attn/wq", "shared_attn/attn/wk", "shared_attn/attn/wv", "shared_attn/attn/wo",
        "shared_attn/mlp/w_gate", "shared_attn/mlp/w_up", "shared_attn/mlp/w_down"}
    whisper = flags("whisper")
    assert whisper["dec_blocks/cross/wq"] and whisper["enc_blocks/attn/wo"] and not whisper["embed"]
    assert flags("odd_vocab")["lm_head"]  # 255 columns: the models take uneven slices


@pytest.mark.parametrize("kvh,g,want", [
    (8, 5, "kvh"),    # qwen3-14b at model 2
    (2, 16, "g"),     # glm4-9b
    (16, 1, "kvh"),   # olmoe-1b-7b
    (2, 2, "g"),      # the smoke configs
    (3, 1, "kvh"),    # neither divides: the larger, uneven
    (1, 3, "g"),
    (3, 3, "kvh"),    # a tie takes the KV heads
])
def test_grouped_head_split_is_the_references_rule(kvh, g, want):
    """``layers.py:26-38`` ``_grouped_head_axes`` at model 2."""
    assert common.grouped_head_split(kvh, g, 2) == want


def test_split_range_covers_the_dim_in_order():
    for n, m in ((8, 2), (51865, 2), (255, 2), (3, 2), (127, 4), (5, 5), (3, 4), (1, 16), (8, 16)):
        parts = [common.split_range(n, m, r) for r in range(m)]
        assert parts[0][0] == 0 and parts[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
        assert max(hi - lo for lo, hi in parts) - min(hi - lo for lo, hi in parts) <= 1
        assert max(hi - lo for lo, hi in parts) == -(-n // m)  # GSPMD's padded part
    assert common.split_range(51865, 2, 0) == (0, 25933)
    # a split wider than its dim: one item each for the first n ranks, then empty parts
    assert [common.split_range(3, 4, r) for r in range(4)] == [(0, 1), (1, 2), (2, 3), (3, 3)]
    assert [common.split_range(8, 16, r) for r in (0, 7, 8, 15)] == [(0, 1), (7, 8), (8, 8), (8, 8)]


# ------------------------------------- without the context, or at model 1
def _aten_ops(fn):
    """The aten ops ``fn`` dispatches, in order."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    with Record() as rec:
        out = fn()
    return rec.ops, out


@pytest.mark.parametrize("case", ["moe", "mla", "whisper"])
def test_model_1_runs_the_one_device_code(case):
    """Under ``tensor_parallel`` of a (1, 1) mesh (world size 1), the loss
    and its gradients dispatch the same aten ops in the same order as with
    no context, and are equal bit for bit."""
    from repro_torch.launch.mesh import init_process_group, make_smoke_mesh
    from repro_torch.training.loop import loss_and_grads

    cfg = dh.tp_config(case)
    lfn, params, batch = api.loss_fn(cfg, plain_kernels=True), dh.f32_params(cfg), dh.train_batch(cfg, 0)
    plain_ops, plain = _aten_ops(lambda: loss_and_grads(lfn, params, batch))
    assert init_process_group("cpu")
    try:
        with common.tensor_parallel(make_smoke_mesh(1, 1, device="cpu")):
            ops, got = _aten_ops(lambda: loss_and_grads(lfn, params, batch))
    finally:
        dist.destroy_process_group()
    assert ops == plain_ops
    assert torch.equal(got[0], plain[0]) and all(torch.equal(a, b) for a, b in zip(got[2], plain[2]))
