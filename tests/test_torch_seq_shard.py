"""Sequence sharding (``cfg.seq_shard``) in the tensor-parallel training
forward: under a ``model`` axis over 1 that divides S, the dense and moe
families (GQA and MLA) hold each model rank's ``S / model`` rows of the
residual stream between blocks, gather the sequence where a split begins
and reduce-scatter it where the split's partial sums leave
(``repro_torch.models.common.sequence_split``).  On gloo ranks on the CPU
(``tests/dist_harness.py``), in f32, with remat on as the train steps set
it, held against:

  * one process, and the same ranks with ``seq_shard`` off;
  * the JAX package's jitted ``value_and_grad`` of ``api.loss_fn`` under
    its (2, 2) host mesh on ``seq_shard`` and remat, as
    ``tests/test_torch_tensor_parallel.py`` runs it.

Tolerances are ``tests/test_torch_tensor_parallel.py``'s, for its reason:
the reduce-scatters sum the ranks' partial products, and the norm scales'
gradients sum the ranks' partial row sums, in another order than one
device, so f32 results differ in summation order only.  Losses within
rtol 1e-5 (atol 1e-6), gradients within atol = rtol 1e-4.

What a checkpoint keeps is read through
``torch.autograd.graph.saved_tensors_hooks``: the block inputs hold
``S / model`` rows, and S rows at an S that ``model`` does not divide.
rwkv6, the hybrid and whisper have no split of the stream: ``seq_shard``
changes nothing there, and at ``model`` 1 it changes no aten op.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import dist_harness as dh
from repro_torch.models import api, common
from repro_torch.models.common import tree_flatten
from test_torch_tensor_parallel import JAX_TP, LOSS_ATOL, LOSS_RTOL, SRC, _aten_ops, _close, _paths

SHAPES = [(1, 2), (2, 2)]
CASES = list(dh.SEQ_CASES)
WHOLE = list(dh.SEQ_WHOLE)


@pytest.fixture(scope="module")
def one():
    """The split families' loss terms and gradients in one process."""
    from repro_torch.training.loop import make_grad_fn

    out = {}
    for case in CASES:
        cfg = dh.seq_config(case)
        loss, parts, grads = make_grad_fn(cfg)(dh.f32_params(cfg), dh.train_batch(cfg, 0))
        out[case] = {"loss": float(loss), "aux": float(parts["aux"]), "grads": grads}
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every split case, on and off, at (1, 2) on 2 gloo ranks and at
    (2, 2) on 4, and the whole-stream families on and off at (1, 2);
    {(data, model, case, "on" | "off" | "uneven"): [per rank]}."""
    root = tmp_path_factory.mktemp("seq")
    two = dh.run_ranks(dh.seq_shard_ranks, 2, str(root / "two"), {(1, 2): (CASES, WHOLE)})
    four = dh.run_ranks(dh.seq_shard_ranks, 4, str(root / "four"), {(2, 2): (CASES, [])})
    return {key: [r[key] for r in rs] for rs in (two, four) for key in rs[0]}


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's jitted value_and_grad of the loss under
    ``make_smoke_mesh(2, 2)`` on 4 host devices, ``seq_shard`` and remat
    on, at the port's f32 parameters and batch."""
    root = tmp_path_factory.mktemp("seq_jax")
    inp = {}
    for case in CASES:
        cfg = dh.seq_config(case)
        params = dh.f32_params(cfg)
        for path, leaf in zip(_paths(params), tree_flatten(params)[0]):
            inp[f"{case}|p|{path}"] = leaf.numpy()
        for k, v in dh.train_batch(cfg, 0).items():
            inp[f"{case}|b|{k}"] = v.numpy().astype(np.int32)
    np.savez(root / "inputs.npz", **inp)
    cases = {c: (dh.TP_CASES[c][0], {**dh.TP_CASES[c][1], "remat": True, "seq_shard": True}) for c in CASES}
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", JAX_TP, str(root / "inputs.npz"), str(root / "out.npz"),
                        json.dumps(cases)], capture_output=True, text=True, env=env, timeout=240)
    assert r.returncode == 0 and "JAX_OK" in r.stdout, r.stderr[-3000:]
    return dict(np.load(root / "out.npz"))


def _same_terms(got, want, what):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL, atol=LOSS_ATOL)
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert len(got["grads"]) == len(want["grads"])
    _close(got["grads"], want["grads"], what)


_ids = {"ids": lambda s: f"data{s[0]}_model{s[1]}"}


@pytest.mark.parametrize("shape", SHAPES, **_ids)
@pytest.mark.parametrize("case", CASES)
def test_split_stream_equals_one_process(case, shape, ranks, one):
    """Each rank's loss, balance term and every gradient leaf (summed over
    ``model`` where the splits leave them partial, then mean-reduced over
    ``data``) against one process over the whole batch."""
    for got in ranks[shape + (case, "on")]:
        _same_terms(got, one[case], case)


@pytest.mark.parametrize("shape", SHAPES, **_ids)
@pytest.mark.parametrize("case", CASES)
def test_split_stream_equals_the_whole_stream_on_the_same_ranks(case, shape, ranks):
    """``seq_shard`` on against off on the same ranks: the same function,
    other collectives."""
    for got, want in zip(ranks[shape + (case, "on")], ranks[shape + (case, "off")]):
        _same_terms(got, want, case)


@pytest.mark.parametrize("shape", SHAPES, **_ids)
@pytest.mark.parametrize("case", CASES)
def test_split_stream_equals_the_reference_under_its_mesh(case, shape, ranks, jax_ref):
    """Against the reference's jitted ``value_and_grad`` under its (2, 2)
    mesh with ``seq_shard`` on, the same f32 parameters and batch."""
    paths = _paths(api.param_specs(dh.tp_config(case)))
    want = {"loss": jax_ref[f"{case}|loss"], "aux": jax_ref[f"{case}|aux"],
            "grads": [jax_ref[f"{case}|g|{p}"] for p in paths]}
    for got in ranks[shape + (case, "on")]:
        _same_terms(got, want, case)


@pytest.mark.parametrize("shape", SHAPES, **_ids)
@pytest.mark.parametrize("case", CASES)
def test_checkpoints_save_the_ranks_rows(case, shape, ranks):
    """Each checkpointed block input holds ``S / model`` rows of the rank's
    ``B / data`` batch rows with ``seq_shard`` on, S with it off, and S at
    an S ``model`` does not divide."""
    cfg = dh.tp_config(case)
    data, model = shape
    B, S = dh.train_batch(cfg, 0)["tokens"].shape
    rows = B // data
    for key, want in (("on", (rows, S // model, cfg.d_model)), ("off", (rows, S, cfg.d_model)),
                      ("uneven", (rows, dh.SEQ_UNEVEN_S, cfg.d_model))):
        for got in ranks[shape + (case, key)]:
            assert got["saved"] == [want] * cfg.n_layers, (key, got["saved"])


@pytest.mark.parametrize("case", CASES)
def test_an_uneven_sequence_keeps_the_stream_whole(case, ranks):
    """At S 31 under ``model`` 2 the rule does not hold: the loss and
    gradients are one process's over the same tokens."""
    from repro_torch.training.loop import make_grad_fn

    cfg = dh.seq_config(case)
    batch = {k: v[:, :dh.SEQ_UNEVEN_S] for k, v in dh.train_batch(cfg, 0).items()}
    loss, parts, grads = make_grad_fn(cfg)(dh.f32_params(cfg), batch)
    for got in ranks[(1, 2, case, "uneven")]:
        _same_terms(got, {"loss": float(loss), "aux": float(parts["aux"]), "grads": grads}, case)


@pytest.mark.parametrize("case", WHOLE)
def test_families_without_the_split_are_unchanged(case, ranks):
    """rwkv6, the hybrid and whisper at (1, 2): ``seq_shard`` on gives the
    loss and gradients of ``seq_shard`` off bit for bit, and every
    checkpoint keeps the whole sequence."""
    S = dh.train_batch(dh.tp_config(case), 0)["tokens"].shape[1]
    for on, off in zip(ranks[(1, 2, case, "on")], ranks[(1, 2, case, "off")]):
        assert on["loss"] == off["loss"] and on["aux"] == off["aux"]
        assert all(torch.equal(a, b) for a, b in zip(on["grads"], off["grads"]))
        assert on["saved"] == off["saved"] and any(s[1] == S for s in on["saved"])


@pytest.mark.parametrize("case", CASES)
def test_model_1_ignores_the_flag(case):
    """Under ``tensor_parallel`` of a (1, 1) mesh (world size 1)
    ``seq_shard`` on dispatches the aten ops of ``seq_shard`` off, in the
    same order, with equal results bit for bit."""
    from repro_torch.launch.mesh import init_process_group, make_smoke_mesh
    from repro_torch.training.loop import loss_and_grads

    batch = dh.train_batch(dh.tp_config(case), 0)
    assert init_process_group("cpu")
    try:
        with common.tensor_parallel(make_smoke_mesh(1, 1, device="cpu")):
            runs = [_aten_ops(lambda c=dh.seq_config(case, on): loss_and_grads(
                api.loss_fn(c, plain_kernels=True), dh.f32_params(c), batch)) for on in (True, False)]
    finally:
        dist.destroy_process_group()
    (ops_on, on), (ops_off, off) = runs
    assert ops_on == ops_off
    assert torch.equal(on[0], off[0]) and all(torch.equal(a, b) for a, b in zip(on[2], off[2]))


def test_the_rule():
    """``common.splits_sequence``: the reference's rule (``seq_shard``,
    ``model`` over 1 and dividing S) in the dense and moe families, with
    no cache."""
    dense, rwkv6 = dh.seq_config("dense"), dh.seq_config("rwkv6")
    assert common.splits_sequence(dense, 32, 2, cached=False)
    assert not common.splits_sequence(dense, 32, 1, cached=False)
    assert not common.splits_sequence(dense, 31, 2, cached=False)
    assert not common.splits_sequence(dense, 32, 2, cached=True)
    assert not common.splits_sequence(dh.seq_config("dense", False), 32, 2, cached=False)
    assert common.splits_sequence(dh.seq_config("moe"), 32, 4, cached=False)
    assert common.splits_sequence(dh.seq_config("mla"), 32, 2, cached=False)
    assert not common.splits_sequence(rwkv6, 32, 2, cached=False)
    assert not common.splits_sequence(dh.seq_config("hybrid"), 32, 2, cached=False)
    assert not common.splits_sequence(dh.seq_config("whisper"), 32, 2, cached=False)
