"""The port's training runtime on the card against the CPU.  Needs a CUDA
device; each test skips without one (decided inside the test, not at
import).  On the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_training.py

Imports no JAX: the machine with the card has none.  chip_smoke.py's
phase ``train`` runs the same path at full width."""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import api
from repro_torch.models.common import tree_flatten, tree_unflatten
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optim
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.loop import loss_and_grads, make_train_step

# f32 on both devices (TF32 is off for matmuls by default): sums in another
# order.  A scalar mean of log-probabilities, and parameters one AdamW step
# (lr 3e-4) apart, where a gradient entry near zero may take the other sign.
F32_LOSS_TOL = 1e-5
F32_PARAM_ATOL = 1e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; chip_smoke.py covers the same checks)")
    return torch.device("cuda")


def _setup(arch="qwen3-14b"):
    """f32 parameters of the smoke config on the CPU and one batch."""
    cfg = get_config(arch, smoke=True)
    params = _to(api.init_params(cfg, 0, "cpu"), "cpu", torch.float32)
    batch = SyntheticLM(DataConfig(cfg.vocab_size, seq_len=32, global_batch=4, seed=0)).batch_at(0)
    return cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()}


def _to(tree, device, dtype=None):
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [t.to(device, dtype or t.dtype, copy=True) for t in leaves])


@pytest.mark.parametrize("arch", ["qwen3-14b", "olmoe-1b-7b"])
def test_train_step_on_the_card_matches_the_cpu(dev, arch):
    cfg, params, batch = _setup(arch)
    ocfg = optim.OptimizerConfig(warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, ocfg)
    out = {}
    for d in ("cpu", dev):
        p = _to(params, d)
        p, state, met = step(p, optim.init_state(ocfg, p), {k: v.to(d) for k, v in batch.items()})
        out[str(d)] = (p, state, {k: float(v) for k, v in met.items()})
    (pc, sc, mc), (pg, sg, mg) = out["cpu"], out["cuda"]
    for k in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(mg[k], mc[k], rtol=F32_LOSS_TOL, atol=F32_LOSS_TOL, err_msg=k)
    assert int(sg["step"]) == 1 and sg["step"].device.type == "cuda"
    for a, b in zip(tree_flatten(pg)[0], tree_flatten(pc)[0]):
        assert a.device.type == "cuda"
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0, atol=F32_PARAM_ATOL)


def test_forward_through_the_kernels_under_grad_raises(dev):
    """The kernels have no backward: differentiating a forward that runs
    them raises the grad guard's error instead of cutting the graph."""
    cfg, params, batch = _setup()
    p = _to(params, dev, torch.bfloat16)
    with pytest.raises(RuntimeError, match="plain_kernels=True"):
        loss_and_grads(api.loss_fn(cfg, plain_kernels=False), p, {k: v.to(dev) for k, v in batch.items()})
    assert not any(t.requires_grad for t in tree_flatten(p)[0])


def test_checkpoint_round_trip_on_the_card(dev, tmp_path):
    cfg, params, _ = _setup()
    ocfg = optim.OptimizerConfig(moment_dtype="bfloat16", factored_second_moment=True)
    p = _to(params, dev, torch.bfloat16)
    tree = {"params": p, "opt": optim.init_state(ocfg, p)}
    ckpt.save(str(tmp_path), 3, tree)
    got, manifest = ckpt.restore(str(tmp_path), 3, tree, device=dev)
    assert manifest["n_leaves"] == len(tree_flatten(tree)[0])
    for a, b in zip(tree_flatten(got)[0], tree_flatten(tree)[0]):
        assert a.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a, b)
