"""The port's training runtime (``repro_torch.training``) against the
reference's (``repro.training``) on the CPU, on the same numpy inputs: the
optimizer's schedule and one AdamW step in both optimizer modes, the train
step over three steps, checkpoints read across the packages in both
directions, the port resuming from a checkpoint the reference wrote, and
remat.  Also the reference's own training tests (tests/test_training.py),
mirrored on the port, apart from the one that needs a mesh."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from parity_harness import MODEL_TOL, jax_params_to_torch, np32

from repro.configs import get_config
from repro.models import api as jax_api
from repro.training import checkpoint as jax_ckpt
from repro.training import loop as jax_loop
from repro.training import optim as jax_optim
from repro_torch.models import api
from repro_torch.models.common import tree_flatten
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optim
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.loop import TrainConfig, make_train_step, train

# Tolerances, each with its reason.
# One optimizer step on the same inputs: both packages do the same f32
# operations in the same order; only the sums inside the gradient norm and
# the factored means run in another order (a few f32 ulps).
STATE_RTOL = 1e-6
# bf16 parameters: p - lr·upd in f32, rounded once to bf16; an f32 update
# a few ulps apart may round to the neighbouring bf16 value.
BF16_ULPS = 1
# f32 train steps: a scalar mean of f32 log-probabilities, and parameters
# after three steps (the reference model tests' f32 tolerance).
F32_LOSS_TOL = 1e-5
F32_MODEL_TOL = 1e-4
# the reference's crash-resume tolerance (tests/test_training.py:118)
RESUME_RTOL, RESUME_ATOL = 1e-5, 1e-6

QUIET = dict(log=lambda *_: None)


# ------------------------------------------------- the reference's tests
def test_adamw_reduces_loss_quadratic():
    ocfg = optim.OptimizerConfig(lr=0.1, warmup_steps=0, total_steps=100, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = optim.init_state(ocfg, params)
    for _ in range(60):
        g = {"w": 2 * params["w"]}
        params, state, _ = optim.apply_updates(ocfg, params, g, state)
    assert float(torch.sum(params["w"] ** 2)) < 0.05


def test_factored_second_moment_shapes():
    ocfg = optim.OptimizerConfig(factored_second_moment=True, moment_dtype="bfloat16")
    params = {"m": torch.zeros((8, 16)), "v1d": torch.zeros((5,))}
    st = optim.init_state(ocfg, params)
    assert st["v"]["m"]["vr"].shape == (8,)
    assert st["v"]["m"]["vc"].shape == (16,)
    assert st["v"]["v1d"]["v"].shape == (5,)  # 1-D params stay unfactored
    assert st["m"]["m"].dtype == torch.bfloat16
    assert st["step"].dtype == torch.int32 and st["step"].dim() == 0


def test_grad_clip():
    g = {"a": torch.full((4,), 100.0)}
    clipped, nrm = optim.clip_by_global_norm(g, 1.0)
    assert float(nrm) == pytest.approx(200.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0, rel=1e-5)


def test_data_deterministic_replay():
    cfg = DataConfig(vocab_size=128, seq_len=32, global_batch=4, seed=3)
    a = SyntheticLM(cfg).batch_at(17)
    b = SyntheticLM(cfg).batch_at(17)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = SyntheticLM(cfg).batch_at(18)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_checkpoint_roundtrip_bf16(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3), "b": {"c": torch.ones((4,))}}
    ckpt.save(str(tmp_path), 5, tree)
    assert ckpt.latest_step(str(tmp_path)) == 5
    restored, manifest = ckpt.restore(str(tmp_path), 5, tree, device="cpu")
    assert manifest["step"] == 5 and manifest["format"] == 1 and manifest["n_leaves"] == 2
    assert restored["a"].dtype == torch.bfloat16 and torch.equal(restored["a"], tree["a"])
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])


def test_checkpoint_tmp_dirs_invisible(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros(3)})
    os.makedirs(str(tmp_path / "step_000000002.tmp"))  # simulated crash
    os.makedirs(str(tmp_path / "step_000000003"))      # no manifest: never committed
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_checkpoint_prune(tmp_path):
    tree = {"a": torch.zeros(2)}
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, tree)
    ckpt.prune(str(tmp_path), keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert sorted(os.listdir(str(tmp_path)))[0] == "step_000000004"


def test_train_crash_resume_identical_trajectory(tmp_path):
    cfg = get_config("qwen3-14b", smoke=True)
    full = train(cfg, TrainConfig(steps=12, ckpt_every=4, ckpt_dir=str(tmp_path / "a"), log_every=100),
                 device="cpu", **QUIET)
    crash_dir = str(tmp_path / "b")
    c1 = train(cfg, TrainConfig(steps=12, ckpt_every=4, ckpt_dir=crash_dir, log_every=100),
               crash_after=6, device="cpu", **QUIET)
    assert c1["crashed"]
    c2 = train(cfg, TrainConfig(steps=12, ckpt_every=4, ckpt_dir=crash_dir, log_every=100), device="cpu", **QUIET)
    assert c2["resumed_from"] == 4  # newest committed checkpoint before the crash
    np.testing.assert_allclose(c2["losses"], full["losses"][4:], rtol=RESUME_RTOL, atol=RESUME_ATOL)


# ------------------------------------------------------ optimizer parity
@pytest.mark.parametrize("warmup,total", [(100, 10_000), (3, 17)])
def test_lr_schedule_matches_reference(warmup, total):
    jcfg = jax_optim.OptimizerConfig(warmup_steps=warmup, total_steps=total)
    tcfg = optim.OptimizerConfig(warmup_steps=warmup, total_steps=total)
    for s in (0, 1, warmup - 1, warmup, (warmup + total) // 2, total, total + 10):
        want = np.asarray(jax_optim.lr_schedule(jcfg, jnp.int32(s)))
        got = optim.lr_schedule(tcfg, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert got.numpy() == want, (s, got, want)  # equal in f32


L, D, F, V = 3, 16, 24, 40


def _optimizer_case(seed, moment_dtype, factored):
    """Leaves of every kind: a stacked (L, D) norm scale, a 3-D block
    weight, the 2-D embedding and the 1-D final norm, bf16; gradients
    whose norm the clip cuts to a third; a state at step 7 with nonzero
    moments.  Returns the numpy inputs and the optimizer config."""
    rng = np.random.default_rng(seed)
    shapes = {"blocks": {"attn_norm": (L, D), "w": (L, D, F)}, "embed": (V, D), "final_norm": (D,)}
    leaves, treedef = jax.tree.flatten(shapes, is_leaf=lambda x: isinstance(x, tuple))
    params = [rng.standard_normal(s).astype(np.float32) * 0.5 for s in leaves]
    grads = [rng.standard_normal(s).astype(np.float32) for s in leaves]
    gn = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in grads))
    grads = [g * (3.0 / gn) for g in grads]
    m = [rng.standard_normal(s).astype(np.float32) * 1e-2 for s in leaves]
    v = []
    for s in leaves:
        if factored and optim._is_factored(s):
            v.append({"vc": rng.random(s[:-2] + s[-1:]).astype(np.float32) * 1e-4,
                      "vr": rng.random(s[:-1]).astype(np.float32) * 1e-4})
        else:
            v.append({"v": rng.random(s).astype(np.float32) * 1e-4})
    unflat = lambda xs: jax.tree.unflatten(treedef, xs)  # noqa: E731
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=50, moment_dtype=moment_dtype, factored_second_moment=factored)
    return unflat(params), unflat(grads), unflat(m), unflat(v), ocfg


def _bf16_ulps(got, want):
    """Distance in bf16 steps of two bf16 arrays (as int16 bit views) of the
    same sign."""
    g, w = got.astype(np.int32), want.astype(np.int32)
    assert np.all((g < 0) == (w < 0))
    return np.abs(g - w)


MODES = pytest.mark.parametrize("moment_dtype,factored", [("float32", False), ("bfloat16", True)],
                                ids=["f32-moments", "bf16-m-factored-v"])


def _apply_both(params, grads, m, v, ocfg):
    """One apply_updates of each package on the same numpy inputs (bf16
    parameters and gradients, state at step 7).  Returns the reference's
    (params, state, metrics), the port's, and the port's inputs before."""
    mdt = jnp.bfloat16 if ocfg["moment_dtype"] == "bfloat16" else jnp.float32
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    jgrads = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), grads)
    jstate = {"step": jnp.int32(7), "m": jax.tree.map(lambda a: jnp.asarray(a, mdt), m),
              "v": jax.tree.map(jnp.asarray, v)}
    tparams, tgrads, tstate = (jax_params_to_torch(t) for t in (jparams, jgrads, jstate))
    before = jax_params_to_torch(jparams)
    want = jax_optim.apply_updates(jax_optim.OptimizerConfig(**ocfg), jparams, jgrads, jstate)
    got = optim.apply_updates(optim.OptimizerConfig(**ocfg), tparams, tgrads, tstate)
    assert got[0] is tparams and got[1] is tstate  # updated in place
    return want, got, before


@MODES
def test_apply_updates_matches_reference(moment_dtype, factored):
    (want_p, want_s, want_om), (got_p, got_s, got_om), before = _apply_both(
        *_optimizer_case(1, moment_dtype, factored))
    assert int(got_s["step"]) == 8 and got_s["step"].dtype == torch.int32
    np.testing.assert_allclose(float(got_om["grad_norm"]), float(want_om["grad_norm"]), rtol=STATE_RTOL)
    assert float(got_om["lr"]) == float(want_om["lr"])
    for got, want in zip(tree_flatten(got_s["v"])[0], jax.tree.leaves(want_s["v"])):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=STATE_RTOL, atol=0)
    for got, want in zip(tree_flatten(got_s["m"])[0], jax.tree.leaves(want_s["m"])):
        if moment_dtype == "float32":
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=STATE_RTOL, atol=0)
        else:
            assert got.dtype == torch.bfloat16
            assert _bf16_ulps(got.view(torch.int16).numpy(), np.asarray(want).view(np.int16)).max() <= BF16_ULPS
    moved = total = 0
    for got, want, old in zip(tree_flatten(got_p)[0], jax.tree.leaves(want_p), tree_flatten(before)[0]):
        want_bits = np.asarray(want).view(np.int16)
        assert _bf16_ulps(got.view(torch.int16).numpy(), want_bits).max() <= BF16_ULPS
        moved += int(np.sum(want_bits != old.view(torch.int16).numpy()))
        total += want_bits.size
    assert moved > total // 2  # the step shows in bf16


@MODES
def test_stacked_norm_scales_are_decayed_and_factored_like_the_reference(moment_dtype, factored):
    """The reference decays every leaf with ndim >= 2 and factors v by the
    last two dims: the blocks' (L, D) norm scales are decayed and, with a
    factored v, get vr (L,) and vc (D,); the 1-D final norm is neither.
    Kept as the reference does it (ROADMAP queue 3 item 7)."""
    params, grads, m, v, ocfg = _optimizer_case(2, moment_dtype, factored)
    for tree in (grads, m):  # a zero gradient and first moment: what moves is the decay alone
        tree["blocks"]["attn_norm"] = np.zeros((L, D), np.float32)
        tree["final_norm"] = np.zeros((D,), np.float32)
    ocfg = dict(ocfg, lr=0.5)
    fresh = optim.init_state(optim.OptimizerConfig(**ocfg), {"blocks": {"attn_norm": torch.zeros(L, D)},
                                                             "final_norm": torch.zeros(D)})
    if factored:
        assert {k: tuple(t.shape) for k, t in fresh["v"]["blocks"]["attn_norm"].items()} == {"vr": (L,), "vc": (D,)}
    else:
        assert set(fresh["v"]["blocks"]["attn_norm"]) == {"v"}
    assert set(fresh["v"]["final_norm"]) == {"v"}
    (want_p, _, want_om), (got_p, _, _), before = _apply_both(params, grads, m, v, ocfg)
    p32 = before["blocks"]["attn_norm"].float()
    decayed = (p32 - (0.1 * p32) * torch.tensor(float(want_om["lr"]))).to(torch.bfloat16)
    assert not torch.equal(decayed, before["blocks"]["attn_norm"])
    for got in (got_p, jax_params_to_torch(want_p)):
        assert torch.equal(got["blocks"]["attn_norm"], decayed)  # decayed: ndim 2
        assert torch.equal(got["final_norm"], before["final_norm"])  # not decayed: ndim 1


# ----------------------------------------------------- train-step parity
def _steps_both(arch, f32, steps=3):
    cfg = get_config(arch, smoke=True)
    jocfg = jax_optim.OptimizerConfig(warmup_steps=1, total_steps=10)
    jparams = jax_api.init_params(cfg, jax.random.key(3))
    if f32:
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    tparams = jax_params_to_torch(jparams, "cpu")
    jstate, tstate = jax_optim.init_state(jocfg, jparams), optim.init_state(optim.OptimizerConfig(**jocfg.__dict__),
                                                                              tparams)
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq_len=32, global_batch=4, seed=3))
    jstep = jax_loop.make_train_step(cfg, jocfg)
    tstep = make_train_step(cfg, optim.OptimizerConfig(**jocfg.__dict__))
    jm, tm = [], []
    for s in range(steps):
        b = data.batch_at(s)
        jparams, jstate, jmet = jstep(jparams, jstate, {k: jnp.asarray(a) for k, a in b.items()})
        tparams, tstate, tmet = tstep(tparams, tstate, {k: torch.from_numpy(a) for k, a in b.items()})
        jm.append({k: float(x) for k, x in jmet.items()})
        tm.append({k: float(x) for k, x in tmet.items()})
    return jparams, tparams, jm, tm


@pytest.mark.parametrize("arch", ["qwen3-14b", "olmoe-1b-7b"])
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_train_step_matches_reference(arch, f32):
    """Three steps of ``make_train_step`` against the reference's on the
    same converted parameters and batches: loss, ce, the moe balance term
    and the grad norm at every step, and (f32) the parameters after."""
    jparams, tparams, jm, tm = _steps_both(arch, f32)
    tol = F32_LOSS_TOL if f32 else MODEL_TOL
    for j, t in zip(jm, tm):
        assert set(t) == {"loss", "ce", "aux", "grad_norm", "lr"}
        # inside the reference's jitted step XLA fuses the schedule's cos,
        # which may land an f32 ulp from the op-by-op value (equal there)
        np.testing.assert_allclose(t["lr"], j["lr"], rtol=STATE_RTOL)
        for k in ("loss", "ce", "aux", "grad_norm"):
            np.testing.assert_allclose(t[k], j[k], rtol=tol, atol=tol, err_msg=k)
    if arch == "olmoe-1b-7b":
        assert all(t["aux"] > 0 for t in tm)
    if f32:
        for got, want in zip(tree_flatten(tparams)[0], jax.tree.leaves(jparams)):
            np.testing.assert_allclose(np32(got), np32(want), rtol=F32_MODEL_TOL, atol=F32_MODEL_TOL)


# ------------------------------------------------- checkpoints, both ways
@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The reference's loop on qwen3-14b-smoke: an uninterrupted 12-step run
    and one that crashes after step 6 with checkpoints every 4 steps."""
    root = tmp_path_factory.mktemp("jax_train")
    cfg = get_config("qwen3-14b", smoke=True)
    full = jax_loop.train(cfg, jax_loop.TrainConfig(steps=12, ckpt_every=4, ckpt_dir=str(root / "full"),
                                                    log_every=100), log=lambda *_: None)
    crash = jax_loop.train(cfg, jax_loop.TrainConfig(steps=12, ckpt_every=4, ckpt_dir=str(root / "crash"),
                                                     log_every=100), crash_after=6, log=lambda *_: None)
    assert crash["crashed"] and jax_ckpt.latest_step(str(root / "crash")) == 4
    return cfg, full, str(root / "crash")


def _like(cfg, ocfg=None):
    ocfg = ocfg or optim.OptimizerConfig()
    params = api.init_params(cfg, 0, "cpu")
    return {"params": params, "opt": optim.init_state(ocfg, params)}


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def test_port_restores_a_reference_checkpoint_bit_for_bit(jax_runs):
    cfg, _, crash_dir = jax_runs
    jlike = {"params": jax_api.init_params(cfg, jax.random.key(0)), "opt": None}
    jlike["opt"] = jax_optim.init_state(jax_optim.OptimizerConfig(), jlike["params"])
    want, wman = jax_ckpt.restore(crash_dir, 4, jlike)
    got, man = ckpt.restore(crash_dir, 4, _like(cfg), device="cpu")
    assert man == wman and man["step"] == 4
    gl, wl = tree_flatten(got)[0], jax.tree.leaves(want)
    assert len(gl) == len(wl) == man["n_leaves"]
    for g, w in zip(gl, wl):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if w.dtype == jnp.bfloat16:
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.view(torch.int16).numpy(), w.view(np.int16))
        else:
            assert g.numpy().dtype == w.dtype
            np.testing.assert_array_equal(g.numpy(), w)
    assert got["opt"]["step"].dtype == torch.int32 and int(got["opt"]["step"]) == 4


def test_reference_restores_a_port_checkpoint_bit_for_bit(tmp_path):
    """A port checkpoint of params and a factored, bf16-moment optimizer
    state after two port steps, read by the reference's restore."""
    cfg = get_config("qwen3-14b", smoke=True)
    ocfg = optim.OptimizerConfig(moment_dtype="bfloat16", factored_second_moment=True, warmup_steps=1)
    params = api.init_params(cfg, 1, "cpu")
    state = optim.init_state(ocfg, params)
    step = make_train_step(cfg, ocfg)
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq_len=32, global_batch=4, seed=1))
    for s in range(2):
        params, state, _ = step(params, state, {k: torch.from_numpy(a) for k, a in data.batch_at(s).items()})
    tree = {"params": params, "opt": state}
    ckpt.save(str(tmp_path), 2, tree, extra={"note": "port"})
    jcfg = jax_optim.OptimizerConfig(moment_dtype="bfloat16", factored_second_moment=True)
    jlike = {"params": jax_api.init_params(cfg, jax.random.key(0)), "opt": None}
    jlike["opt"] = jax_optim.init_state(jcfg, jlike["params"])
    assert jax_ckpt.latest_step(str(tmp_path)) == 2
    want, man = jax_ckpt.restore(str(tmp_path), 2, jlike)
    assert man["extra"] == {"note": "port"} and man["n_leaves"] == 56
    for g, w in zip(tree_flatten(tree)[0], jax.tree.leaves(want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(_bits(w), g.view(torch.int16).numpy() if g.dtype == torch.bfloat16
                                      else g.numpy())
    assert np.asarray(want["opt"]["step"]).dtype == np.int32


def test_checkpoint_leaf_order_is_the_references():
    """The {"params", "opt"} tree of qwen3-14b-smoke with a factored v
    flattens to 56 leaves: opt.m.*, opt.step, opt.v.*.{vc, vr | v},
    params.*, each group in sorted-key order."""
    cfg = get_config("qwen3-14b", smoke=True)
    ocfg = optim.OptimizerConfig(factored_second_moment=True)
    tree = _like(cfg, ocfg)
    jcfg = jax_optim.OptimizerConfig(factored_second_moment=True)
    jtree = {"params": jax_api.init_params(cfg, jax.random.key(0)), "opt": None}
    jtree["opt"] = jax_optim.init_state(jcfg, jtree["params"])
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    leaves = tree_flatten(tree)[0]
    n = len(tree_flatten(tree["params"])[0])
    assert len(leaves) == len(paths) == 56
    assert all(p.startswith("['opt']['m']") for p in paths[:n]) and paths[n] == "['opt']['step']"
    assert paths[n + 1].startswith("['opt']['v']") and paths[n + 1].endswith("['vc']")
    assert all(p.startswith("['params']") for p in paths[-n:])
    for t, (p, j) in zip(leaves, jax.tree_util.tree_flatten_with_path(jtree)[0]):
        assert tuple(t.shape) == np.shape(j), jax.tree_util.keystr(p)


def test_port_resumes_from_a_reference_checkpoint(jax_runs, tmp_path):
    """The reference crashed after step 6 with its newest checkpoint at step
    4; the port's loop resumes from it and its losses for steps 5-12 follow
    the reference's uninterrupted run (bf16 models on both sides)."""
    cfg, full, crash_dir = jax_runs
    resume_dir = str(tmp_path / "resume")
    shutil.copytree(crash_dir, resume_dir)
    lines = []
    res = train(cfg, TrainConfig(steps=12, ckpt_every=4, ckpt_dir=resume_dir, log_every=100), log=lines.append,
                device="cpu")
    assert res["resumed_from"] == 4 and lines[0] == "[train] resumed from step 4"
    assert len(res["losses"]) == 8 and not res["crashed"]
    np.testing.assert_allclose(res["losses"], full["losses"][4:], rtol=0, atol=MODEL_TOL)
    assert ckpt.latest_step(resume_dir) == 12


# ------------------------------------------------------------------ remat
@pytest.mark.parametrize("arch", ["qwen3-14b", "rwkv6-1.6b", "zamba2-1.2b", "whisper-small"])
def test_remat_gradients_equal_without(arch):
    """``cfg.remat`` recomputes each block in the backward: the same loss
    and the same gradients, bit for bit on the CPU."""
    import dataclasses

    cfg = get_config(arch, smoke=True)
    params = api.init_params(cfg, 2, "cpu")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal((2, cfg.enc_frames, cfg.d_model),
                                                               dtype=np.float32)).to(torch.bfloat16)
    leaves = tree_flatten(params)[0]
    out = []
    for remat in (False, True):
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss, _ = api.loss_fn(dataclasses.replace(cfg, remat=remat), plain_kernels=True)(params, batch)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
        for leaf in leaves:
            leaf.requires_grad_(False)
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert any(bool(a.abs().sum() > 0) for a in g0)
