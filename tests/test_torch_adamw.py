"""The fused AdamW (``repro_torch.kernels.adamw``) against the reference's
optimizer (``repro.training.optim.apply_updates``) under CPU JAX, on the
same numpy inputs: its plain versions (``kernels/adamw/ref.py``) called
leaf by leaf, and ``training.optim.apply_updates`` through them.  On the
CPU the ops run the plain versions; the CUDA kernels are held against
them on the card (``chip_smoke.py`` phase ``adamw``,
``tests/test_torch_cuda_adamw.py``).

Cases: the three optimizer paths of the reference's configs (f32 moments,
the loop's default; bf16 m; bf16 m with a factored v, for archs over 50 B
parameters), a stacked 3-D, a 2-D and a 1-D leaf (1-D: no decay, never
factored), steps 1 and 7, the clip active and inactive.  Also: after a
step every tensor of the state is the one it was, updated in place (what
a replayed CUDA graph needs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from parity_harness import jax_params_to_torch

from repro.training import optim as jax_optim
from repro_torch.kernels import adamw
from repro_torch.models.common import tree_flatten
from repro_torch.training import optim

# Tolerances, each with its reason.
# f32 state: both do the same f32 operations in the same order; only the
# sums (the gradient norm, the factored means) run in another order and,
# here, in f64 (a few f32 ulps at most).
STATE_RTOL = 1e-6
# bf16 parameters and a bf16 m: an f32 result a few ulps apart may round to
# the neighbouring bf16 value.
BF16_ULPS = 1

PATHS = {"f32-moments": dict(moment_dtype="float32", factored_second_moment=False),
         "bf16-m": dict(moment_dtype="bfloat16", factored_second_moment=False),
         "bf16-m-factored-v": dict(moment_dtype="bfloat16", factored_second_moment=True)}
LEAVES = {"3d": (3, 16, 24), "2d": (40, 16), "1d": (16,)}
CLIP_NORMS = {"clip-active": 3.0, "clip-inactive": 0.5}  # the gradient's norm; grad_clip is 1.0


def _case(seed, path, shape, step, grad_norm, dtype=jnp.bfloat16):
    """Numpy inputs of one leaf ``w``: a parameter, a gradient of norm
    ``grad_norm``, moments at state step ``step - 1``; the reference's
    (params, grads, state) in JAX, and the optimizer config."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(shape).astype(np.float32) * 0.5
    g = rng.standard_normal(shape).astype(np.float32)
    g *= grad_norm / np.sqrt(np.sum(g.astype(np.float64) ** 2))
    m = rng.standard_normal(shape).astype(np.float32) * 1e-2
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=50, **PATHS[path])
    if ocfg["factored_second_moment"] and optim._is_factored(shape):
        v = {"vc": rng.random(shape[:-2] + shape[-1:]).astype(np.float32) * 1e-4,
             "vr": rng.random(shape[:-1]).astype(np.float32) * 1e-4}
    else:
        v = {"v": rng.random(shape).astype(np.float32) * 1e-4}
    mdt = jnp.bfloat16 if ocfg["moment_dtype"] == "bfloat16" else jnp.float32
    jparams, jgrads = {"w": jnp.asarray(p, dtype)}, {"w": jnp.asarray(g, dtype)}
    jstate = {"step": jnp.int32(step - 1), "m": {"w": jnp.asarray(m, mdt)},
              "v": {"w": {k: jnp.asarray(a) for k, a in v.items()}}}
    return jparams, jgrads, jstate, ocfg


def _bf16_ulps(got: torch.Tensor, want) -> int:
    """Distance in bf16 steps of two bf16 arrays of the same signs."""
    g = got.view(torch.int16).numpy().astype(np.int32)
    w = np.asarray(want).view(np.int16).astype(np.int32)
    assert np.all((g < 0) == (w < 0))
    return int(np.abs(g - w).max())


def _assert_matches(got_p, got_m, got_v, want_p, want_s, m_scale=None):
    """The port's p, m and v tensors of leaf ``w`` against the reference's
    new params and state; an f32 m within STATE_RTOL of ``m_scale`` where
    one is given (the operands' scale), else of itself."""
    want_v = want_s["v"]["w"]
    assert sorted(got_v) == sorted(want_v)
    for k, t in got_v.items():
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(want_v[k]), rtol=STATE_RTOL, atol=0, err_msg=k)
    want_m = want_s["m"]["w"]
    if got_m.dtype == torch.float32 and m_scale is not None:
        assert np.all(np.abs(got_m.numpy() - np.asarray(want_m)) <= STATE_RTOL * m_scale)
    elif got_m.dtype == torch.float32:
        np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=STATE_RTOL, atol=0)
    else:
        assert _bf16_ulps(got_m, want_m) <= BF16_ULPS
    if got_p.dtype == torch.bfloat16:
        assert _bf16_ulps(got_p, want_p["w"]) <= BF16_ULPS
    else:
        np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p["w"]), rtol=STATE_RTOL, atol=1e-7)


def _reference(jparams, jgrads, jstate, ocfg):
    return jax_optim.apply_updates(jax_optim.OptimizerConfig(**ocfg), jparams, jgrads, jstate)


def _plain_step(ocfg, p, g, m, v, step):
    """One step of leaf ``p`` through the plain versions alone, as
    ``apply_updates`` sequences them: the norm, the step's scalars, then
    the factored statistics and the update.  Returns (grad norm, lr)."""
    cfg = optim.OptimizerConfig(**ocfg)
    gnorm = torch.sqrt(adamw.sq_norm_ref(g).to(torch.float32))
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    t = torch.tensor(step, dtype=torch.float32)
    lr = optim.lr_schedule(cfg, torch.tensor(step, dtype=torch.int32))
    b1, b2 = cfg.betas
    scalars = torch.stack([scale, lr, 1 - b1**t, 1 - b2**t])
    hyper = dict(b1=b1, b2=b2, eps=cfg.eps, wd=cfg.weight_decay, decay=p.dim() >= 2)
    if "v" in v:
        adamw.adamw_update_ref(p, g, m, v["v"], None, None, None, scalars, **hyper)
    else:
        denom = torch.empty(p.shape[:-2])
        adamw.factored_stats_ref(g, v["vr"], v["vc"], denom, scalars, b2)
        adamw.adamw_update_ref(p, g, m, None, v["vr"], v["vc"], denom, scalars, **hyper)
    return gnorm, lr


CASES = pytest.mark.parametrize("path", sorted(PATHS))
KINDS = pytest.mark.parametrize("kind", sorted(LEAVES))
STEPS = pytest.mark.parametrize("step", [1, 7])
CLIPS = pytest.mark.parametrize("clip", sorted(CLIP_NORMS))


@CASES
@KINDS
@STEPS
@CLIPS
def test_plain_versions_match_reference(path, kind, step, clip):
    jparams, jgrads, jstate, ocfg = _case(0, path, LEAVES[kind], step, CLIP_NORMS[clip])
    want_p, want_s, want_om = _reference(jparams, jgrads, jstate, ocfg)
    p, g = jax_params_to_torch(jparams)["w"], jax_params_to_torch(jgrads)["w"]
    state = jax_params_to_torch(jstate)
    m, v = state["m"]["w"], state["v"]["w"]
    gnorm, lr = _plain_step(ocfg, p, g, m, v, step)
    np.testing.assert_allclose(float(gnorm), float(want_om["grad_norm"]), rtol=STATE_RTOL)
    assert float(lr) == float(want_om["lr"])
    _assert_matches(p, m, v, want_p, want_s)


@CASES
@KINDS
@STEPS
@CLIPS
def test_apply_updates_through_the_fused_ops_matches_reference(path, kind, step, clip):
    jparams, jgrads, jstate, ocfg = _case(1, path, LEAVES[kind], step, CLIP_NORMS[clip])
    want_p, want_s, want_om = _reference(jparams, jgrads, jstate, ocfg)
    params, grads, state = (jax_params_to_torch(t) for t in (jparams, jgrads, jstate))
    got_p, got_s, got_om = optim.apply_updates(optim.OptimizerConfig(**ocfg), params, grads, state)
    assert int(got_s["step"]) == step and int(want_s["step"]) == step
    np.testing.assert_allclose(float(got_om["grad_norm"]), float(want_om["grad_norm"]), rtol=STATE_RTOL)
    assert float(got_om["lr"]) == float(want_om["lr"])
    _assert_matches(got_p["w"], got_s["m"]["w"], got_s["v"]["w"], want_p, want_s)


@CASES
def test_apply_updates_matches_reference_with_f32_parameters(path):
    """A phase that trains in f32 (tensor-parallel, f32 copies of the
    weights): the clipped gradient is rounded to f32, i.e. kept.  The two
    clip scales may lie an f32 ulp apart (the norm is summed in f64 here,
    in f32 there), and no bf16 rounding of the clipped gradient hides it:
    where b1·m and (1 - b1)·g cancel, that ulp is a large share of m, so
    m is held within STATE_RTOL of its operands' scale."""
    jparams, jgrads, jstate, ocfg = _case(2, path, LEAVES["3d"], 7, CLIP_NORMS["clip-active"], jnp.float32)
    b1 = jax_optim.OptimizerConfig().betas[0]
    m_scale = (b1 * np.abs(np.asarray(jstate["m"]["w"], np.float32))
               + (1 - b1) * np.abs(np.asarray(jgrads["w"], np.float32)))
    want_p, want_s, want_om = _reference(jparams, jgrads, jstate, ocfg)
    params, grads, state = (jax_params_to_torch(t) for t in (jparams, jgrads, jstate))
    got_p, got_s, got_om = optim.apply_updates(optim.OptimizerConfig(**ocfg), params, grads, state)
    assert got_p["w"].dtype == torch.float32
    np.testing.assert_allclose(float(got_om["grad_norm"]), float(want_om["grad_norm"]), rtol=STATE_RTOL)
    _assert_matches(got_p["w"], got_s["m"]["w"], got_s["v"]["w"], want_p, want_s, m_scale)


@CASES
def test_a_step_updates_every_state_tensor_in_place(path):
    """A replayed CUDA graph writes the tensors it captured: the step
    counter and every p, m, v, vr and vc must be the same objects, at the
    same addresses, after a step, their values moved."""
    ocfg = optim.OptimizerConfig(lr=1e-2, warmup_steps=1, **PATHS[path])
    rng = np.random.default_rng(3)
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
              for k, s in LEAVES.items()}
    grads = {k: torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32)).to(torch.bfloat16)
             for k, t in params.items()}
    state = optim.init_state(ocfg, params)
    tensors = [state["step"]] + tree_flatten(params)[0] + tree_flatten(state["m"])[0] + tree_flatten(state["v"])[0]
    before = [(t, t.data_ptr(), t.clone()) for t in tensors]
    factored = {k for k, d in state["v"].items() if "vr" in d}
    assert factored == ({"2d", "3d"} if ocfg.factored_second_moment else set())
    got_p, got_s, _ = optim.apply_updates(ocfg, params, grads, state)
    assert got_p is params and got_s is state
    after = [state["step"]] + tree_flatten(params)[0] + tree_flatten(state["m"])[0] + tree_flatten(state["v"])[0]
    for (t, ptr, old), new in zip(before, after):
        assert new is t and new.data_ptr() == ptr
        assert not torch.equal(new, old)
    assert int(state["step"]) == 1


def test_factored_stats_keep_the_reference_shapes_and_divisor():
    """vr (..., R), vc (..., C) and the divisor (...) of a stacked leaf, as
    the reference's ``_update_leaf`` reduces them; a zero gradient leaves
    b2·v and the divisor at its floor where vc is zero."""
    g = torch.zeros(3, 16, 24, dtype=torch.bfloat16)
    vr, vc = torch.full((3, 16), 2.0), torch.zeros(3, 24)
    scalars = torch.tensor([1.0, 1e-3, 0.1, 0.05])
    denom = adamw.factored_stats(g, vr, vc, scalars, 0.95)
    assert denom.shape == (3,) and denom.dtype == torch.float32
    assert torch.equal(vr, torch.full((3, 16), 2.0 * np.float32(0.95)))
    assert torch.equal(denom, torch.full((3,), np.float32(1e-30)))


def test_the_ops_refuse_what_the_kernels_do_not_take():
    p = torch.zeros(4, 8)
    scalars = torch.zeros(4)
    with pytest.raises(TypeError):
        adamw.sq_norms([torch.zeros(4, dtype=torch.float16)])
    with pytest.raises(ValueError):
        adamw.adamw_update(p, torch.zeros(4, 8, dtype=torch.bfloat16), p.clone(), p.clone(), scalars,
                           b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    with pytest.raises(ValueError):  # neither v nor the factored statistics
        adamw.adamw_update(p, p.clone(), p.clone(), None, scalars, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    with pytest.raises(ValueError):
        adamw.factored_stats(p, torch.zeros(8), torch.zeros(4), scalars, 0.95)
