"""The fused AdamW's kernels (``repro_torch.kernels.adamw``) and the captured
train step on the card.  Needs a CUDA device; each test skips without one
(decided inside the test, not at import).  On the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_adamw.py

Imports no JAX: the machine with the card has none.  Each kernel against
its plain version on the same CUDA tensors, on every path, at shapes that
take the 16-byte and the one-element instances (a leaf whose start is off
16 bytes, a ragged last vector, a column count that is not whole vectors,
more rows than one tile); the train step captured as ``train`` captures
it against the same steps run eagerly, bit for bit.  chip_smoke.py's
phases ``adamw`` and ``train`` run the same checks at full width."""

import numpy as np
import pytest
import torch

from repro_torch import graphs, kernels
from repro_torch.configs import get_config
from repro_torch.kernels import adamw
from repro_torch.models import api
from repro_torch.models.common import tree_flatten
from repro_torch.training import optim
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.loop import make_train_step

# The same f32 operations element by element, each rounded alike: p, m and v
# bit for bit where their inputs agree.  The sums are f64 in another order,
# rounded once: the norm within 1e-12, vr, vc and the divisor within 1e-6
# (an f32 ulp or two), and what reads them within one bf16 step.
NORM_RTOL = 1e-12
STATE_RTOL = 1e-6

SHAPES = {"3d": (3, 200, 136), "2d": (300, 24), "1d": (1001,), "ragged-cols": (2, 40, 13)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; chip_smoke.py covers the same checks)")
    return torch.device("cuda")


def _leaf(shape, mdt, factored, dev, offset, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(scale, dtype):
        flat = torch.randn(offset + int(np.prod(shape)), generator=gen, device=dev) * scale
        return flat.to(dtype)[offset:].view(shape)  # ``offset`` elements past 16 bytes

    leaf = {"p": randn(0.5, torch.bfloat16), "g": randn(1.0, torch.bfloat16), "m": randn(1e-2, mdt)}
    if factored and optim._is_factored(shape):
        leaf["vr"] = torch.rand(shape[:-1], generator=gen, device=dev) * 1e-4
        leaf["vc"] = torch.rand(shape[:-2] + shape[-1:], generator=gen, device=dev) * 1e-4
    else:
        leaf["v"] = torch.rand(shape, generator=gen, device=dev) * 1e-4
    return leaf


def _steps(x):
    """bf16 steps at |x|."""
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), torch.frexp(x.float().abs())[1] - 8)


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "off-16-bytes"])
@pytest.mark.parametrize("kind", sorted(SHAPES))
@pytest.mark.parametrize("path", ["f32-moments", "bf16-m", "bf16-m-factored-v"])
def test_kernels_match_their_plain_versions(dev, path, kind, offset):
    shape = SHAPES[kind]
    mdt = torch.float32 if path == "f32-moments" else torch.bfloat16
    leaf = _leaf(shape, mdt, path.endswith("factored-v"), dev, offset)
    plain = {k: t.clone() for k, t in leaf.items()}
    b1, b2, eps, wd = 0.9, 0.95, 1e-8, 0.1
    kernels.reset_launch_counts()
    norm = adamw.sq_norms([leaf["g"]])
    want_norm = adamw.sq_norm_ref(leaf["g"])
    assert float((norm[0] - want_norm).abs() / want_norm) <= NORM_RTOL
    scale = torch.clamp(1.0 / torch.sqrt(norm.sum().float()), max=1.0)
    scalars = torch.stack([scale, torch.tensor(3e-3, device=dev), torch.tensor(0.52, device=dev),
                           torch.tensor(0.3, device=dev)])
    denom = plain_denom = None
    if "vr" in leaf:
        denom = adamw.factored_stats(leaf["g"], leaf["vr"], leaf["vc"], scalars, b2)
        plain_denom = torch.empty_like(denom)
        adamw.factored_stats_ref(plain["g"], plain["vr"], plain["vc"], plain_denom, scalars, b2)
    adamw.adamw_update(leaf["p"], leaf["g"], leaf["m"], leaf.get("v"), scalars, b1=b1, b2=b2, eps=eps,
                       weight_decay=wd, vr=leaf.get("vr"), vc=leaf.get("vc"), denom=denom)
    adamw.adamw_update_ref(plain["p"], plain["g"], plain["m"], plain.get("v"), plain.get("vr"), plain.get("vc"),
                           plain_denom, scalars, b1, b2, eps, wd, len(shape) >= 2)
    torch.cuda.synchronize()
    factored = "vr" in leaf
    assert kernels.launch_counts()["sq_norm"] == 1 and kernels.launch_counts()["adamw_update"] == 1
    assert kernels.launch_counts()["factored_stats"] == int(factored)
    for k in ("v", "vr", "vc"):
        if k in leaf:
            rtol = STATE_RTOL if factored else 0.0
            torch.testing.assert_close(leaf[k], plain[k], rtol=rtol, atol=0)
    if factored:
        torch.testing.assert_close(denom, plain_denom, rtol=STATE_RTOL, atol=0)
    for k in ("p", "m"):
        d = (leaf[k].float() - plain[k].float()).abs()
        limit = _steps(plain[k]) if factored and k == "p" else torch.zeros_like(d)
        assert bool((d <= limit).all()), (k, float(d.max()))


def test_the_update_of_an_f32_leaf_is_the_plain_versions_bit_for_bit(dev):
    leaf = {"p": torch.randn(5, 77, device=dev), "g": torch.randn(5, 77, device=dev),
            "m": torch.randn(5, 77, device=dev) * 1e-2, "v": torch.rand(5, 77, device=dev) * 1e-4}
    plain = {k: t.clone() for k, t in leaf.items()}
    scalars = torch.tensor([0.25, 1e-3, 0.41, 0.2], device=dev)
    adamw.adamw_update(leaf["p"], leaf["g"], leaf["m"], leaf["v"], scalars, b1=0.9, b2=0.95, eps=1e-8,
                       weight_decay=0.1)
    adamw.adamw_update_ref(plain["p"], plain["g"], plain["m"], plain["v"], None, None, None, scalars, 0.9, 0.95,
                           1e-8, 0.1, True)
    for k in leaf:
        assert torch.equal(leaf[k], plain[k]), k


def test_a_captured_train_step_equals_the_eager_step_bit_for_bit(dev):
    """qwen3-14b-smoke, bf16, the loop's optimizer: five eager steps, then
    five from the same state through the step captured as ``train``
    captures it (two warm calls, a capture, three replays): the same
    losses and parameters, bit for bit; a replay runs no wrapper."""
    cfg = get_config("qwen3-14b", smoke=True)
    ocfg = optim.OptimizerConfig(warmup_steps=1, total_steps=10)
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq_len=32, global_batch=4, seed=0))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(i).items()} for i in range(5)]
    runs = []
    for captured in (False, True):
        params = api.init_params(cfg, 0, dev)
        state = optim.init_state(ocfg, params)
        step = make_train_step(cfg, ocfg)
        if captured:
            step = graphs.capture(step, params, state, batches[0], held=(0, 1), warm_on_calls=True)
        losses = [float(step(params, state, b)[2]["loss"]) for b in batches]
        runs.append((losses, [t.clone() for t in tree_flatten(params)[0]], int(state["step"])))
    (eager, eager_p, eager_step), (graph, graph_p, graph_step) = runs
    assert graph == eager and eager_step == graph_step == 5
    assert all(torch.equal(a, b) for a, b in zip(graph_p, eager_p))
    assert step.replays == 5 - graphs.WARM_CALLS
    n = len(graph_p)
    assert step.launches == {**dict.fromkeys(kernels.launch_counts(), 0), "sq_norm": n, "adamw_update": n}


def test_build_train_step_captures_at_its_first_cuda_call(dev):
    from repro_torch.launch.steps import build_train_step

    cfg = get_config("qwen3-14b", smoke=True)
    step, ocfg = build_train_step(cfg)
    params = api.init_params(cfg, 0, dev)
    state = optim.init_state(ocfg, params)
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq_len=32, global_batch=4, seed=0))
    for i in range(graphs.WARM_CALLS + 2):
        step(params, state, {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(i).items()})
    assert step.captured is not None and step.captured.replays == 2 and int(state["step"]) == graphs.WARM_CALLS + 2
