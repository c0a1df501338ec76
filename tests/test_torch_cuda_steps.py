"""The port's captured steps (``repro_torch.graphs.capture``) on the
card: a captured prefill and decode against the same steps run eagerly
through the same kernels, the launches a replay runs (read from a device
trace: a replay runs no wrapper to count them), and the calls a captured
step refuses.  Needs a CUDA device; each test skips without
one (decided inside the test, not at import).  On the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_steps.py

Imports no JAX: the machine with the card has none.  chip_smoke.py's
phase ``steps`` runs the same comparison at full width."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig, smoke_variant
from repro_torch.graphs import WARM_CALLS, capture
from repro_torch.launch.serve_e2e import greedy_decode, make_greedy_steps
from repro_torch.launch.steps import build_decode_step, build_prefill_step
from repro_torch.models import api

# smoke depth at a head dim the kernels take (64): attention, WKV and SSD
ARCHS = ["qwen3-14b", "rwkv6-1.6b", "zamba2-1.2b"]
S, DECODE = 40, 6
# the graph replays the kernels and matmuls the eager step launches, on the
# same inputs; the gate of chip_smoke.py's phase steps
LOGIT_REL_TOL = 0.01


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card; chip_smoke.py covers the same checks)")
    return torch.device("cuda")


def _model(arch, dev):
    base = get_config(arch)
    extra = {"ssm_heads": 8} if base.family == "hybrid" else {}  # SSD head size 512 / 8 = 64
    cfg = smoke_variant(base, d_model=256, d_head=64, **extra)
    return cfg, api.init_params(cfg, 0, dev)


@pytest.mark.parametrize("arch", ARCHS)
def test_captured_greedy_decode_equals_eager(dev, arch):
    cfg, params = _model(arch, dev)
    prompt = torch.randint(0, cfg.vocab_size, (S,), generator=torch.Generator().manual_seed(0)).tolist()
    got = greedy_decode(cfg, params, prompt, DECODE, dev)
    want = greedy_decode(cfg, params, prompt, DECODE, dev, graphs=False)
    assert got[0] == want[0] and got[1] == want[1]
    gap = float((got[2] - want[2]).abs().max())
    assert gap <= LOGIT_REL_TOL * float(want[2].abs().max())


def test_greedy_steps_are_captured_once_and_reused(dev):
    """``make_greedy_steps`` captures once; each ``greedy_decode`` on those
    steps starts from a zeroed cache and gives the same tokens, one
    prefill replay and DECODE decode replays a run."""
    cfg, params = _model("qwen3-14b", dev)
    prompt = torch.randint(0, cfg.vocab_size, (S,), generator=torch.Generator().manual_seed(1)).tolist()
    steps = make_greedy_steps(cfg, params, S, DECODE, dev)
    first = greedy_decode(cfg, params, prompt, DECODE, dev, steps=steps)
    again = greedy_decode(cfg, params, prompt, DECODE, dev, steps=steps)
    assert first[0] == again[0] and bool(torch.equal(first[2], again[2]))
    assert (steps.prefill.replays, steps.decode.replays) == (2, 2 * DECODE)
    with pytest.raises(ValueError, match="asked for"):
        greedy_decode(cfg, params, prompt[:-1], DECODE, dev, steps=steps)


@pytest.mark.parametrize("arch", ARCHS)
def test_a_replay_runs_the_captured_launches(dev, arch):
    """The capture records one eager prefill's launches into the graph; a
    replay runs no wrapper and adds nothing to the wrappers' counts, and a
    device trace of one replay shows the same launches."""
    from torch.profiler import ProfilerActivity, profile

    cfg, params = _model(arch, dev)
    toks = {"tokens": torch.zeros((1, S), dtype=torch.int64, device=dev)}
    kernels.reset_launch_counts()
    step = capture(build_prefill_step(cfg, ShapeConfig("p", S, 1, "prefill")), params, toks, held=(0,))
    assert any(step.launches.values()) and step.capture_s > 0 and step.replays == 0
    # the warm calls and the capture ran the wrappers
    assert kernels.launch_counts() == {k: (WARM_CALLS + 1) * n for k, n in step.launches.items()}
    kernels.reset_launch_counts()
    eager = build_prefill_step(cfg, ShapeConfig("p", S, 1, "prefill"))
    with torch.inference_mode():
        want_logits, _ = eager(params, toks)
    assert kernels.launch_counts() == step.launches  # what the graph captured is one eager prefill
    kernels.reset_launch_counts()
    for _ in range(3):
        logits, _ = step(params, toks)
    torch.cuda.synchronize()
    assert step.replays == 3 and not any(kernels.launch_counts().values())
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(params, toks)
        torch.cuda.synchronize()
    runs = [(e.key, e.count) for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert kernels.traced_launch_counts(runs) == step.launches
    assert float((logits.float() - want_logits.float()).abs().max()) <= \
        LOGIT_REL_TOL * float(want_logits.float().abs().max())


def test_a_captured_step_refuses_other_held_tensors_and_shapes(dev):
    cfg, params = _model("qwen3-14b", dev)
    cache = api.init_cache(cfg, 1, S, dev)
    pos = torch.tensor(S - 1, dtype=torch.int32, device=dev)
    tok = torch.zeros((1, 1), dtype=torch.int64, device=dev)
    step = capture(build_decode_step(cfg, ShapeConfig("d", S, 1, "decode")), params, tok, cache, pos, held=(0, 2))
    step(params, tok, cache, pos)  # the captured tensors: replays
    with pytest.raises(ValueError, match="held by reference"):
        step(params, tok, api.init_cache(cfg, 1, S, dev), pos)
    other = dict(params, final_norm=params["final_norm"].clone())
    with pytest.raises(ValueError, match="held by reference"):
        step(other, tok, cache, pos)
    with pytest.raises(ValueError, match="capture a step for this shape"):
        step(params, torch.zeros((2, 1), dtype=torch.int64, device=dev), cache, pos)


def test_a_capture_that_fails_raises_rather_than_run_eagerly(dev):
    """A step that reads a value on the host cannot be captured: capture
    raises, and the launch counts are what they were.  In a process of its
    own: a failed capture leaves torch's capture stream, allocator pool and
    default generator in their capturing state, which would fail the tests
    that run after it in this process."""
    code = textwrap.dedent("""
        import torch
        from repro_torch import kernels
        from repro_torch.graphs import capture

        def syncs(x):
            return x * float(x.sum())  # a host read: legal eagerly, not while capturing

        x = torch.ones(4, device="cuda")
        before = kernels.launch_counts()
        try:
            capture(syncs, x)
        except RuntimeError:
            assert kernels.launch_counts() == before
            print("raised")
    """)
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-1] == "raised"
