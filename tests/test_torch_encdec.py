"""The port's Whisper encoder-decoder (``repro_torch.models.encdec``) and its
loss entry points against the reference at smoke size, on the CPU, with
the reference's parameters converted through ``repro_torch.models.convert``
and the same numpy frames and tokens on both sides.

Each model case runs at enc_frames 16 (the smoke config's) and at 1500
(whisper-small's own frame count): there the reference's attention takes
its chunked branch (T > ATTN_CHUNK = 1024, keys padded to 2048 and masked
by kv_len), and the port's encoder and cross-attention take the flash
kernel's full entry point over a key count that is no block multiple;
decode reads the cross cache as 94 pages of 16 slots, kv_len 1500."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from parity_harness import MODEL_TOL, jax_params_to_torch, np32, torch_from

from repro.configs import ARCH_IDS, get_config, smoke_variant
from repro.models import api as jax_api
from repro.models import encdec as jax_encdec
from repro_torch.launch.serve_e2e import greedy_decode
from repro_torch.models import api, encdec, transformer
from repro_torch.serving import calibrate_host_flops

B, S, HALF = 2, 16, 8
ENC_FRAMES = [16, 1500]
DTYPES = pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])

# Tolerances, each with its reason.
# f32 parameters, frames and caches: both packages run the same f32
# arithmetic with sums in another order (worst seen 2.7e-6 on logits).
F32_MODEL_TOL = 1e-4
# bf16, the model's own dtype: MODEL_TOL, with its atol taken as a share of
# the largest |value| of the tensor.  Whisper-smoke stacks four bf16 layers
# (two encoder, two decoder with cross-attention), and XLA's CPU fusions
# keep f32 between elementwise ops where torch rounds each to bf16; a few
# bf16 steps of the largest logit then land on logits near zero as well
# (worst seen 0.059 on a logit of 0.016, at max |logit| 3.3).  The f32
# cases hold the arithmetic itself.
# chained prefill against one prefill of the whole prompt, both through the
# port in bf16: the reference's own tolerance for the same invariant
# (tests/test_models.py:93)
CHAIN_TOL = 0.1
F32_LOSS_TOL = 1e-5  # a scalar mean of f32 log-probabilities
GRAD_TOL = 1e-4  # of the largest gradient entry of the leaf, f32


def _setup(enc_frames, seed=0, f32=False):
    cfg = smoke_variant(get_config("whisper-small"), enc_frames=enc_frames)
    jparams = jax_api.init_params(cfg, jax.random.key(seed))
    if f32:
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = rng.standard_normal((B, enc_frames, cfg.d_model)).astype(np.float32)
    return cfg, jparams, jax_params_to_torch(jparams, "cpu"), toks, frames


def _frames(frames, f32=False):
    """The same frames for both packages, bf16 unless ``f32``."""
    return (jnp.asarray(frames, jnp.float32 if f32 else jnp.bfloat16),
            torch_from(frames, torch.float32 if f32 else torch.bfloat16))


def _caches(cfg, f32):
    jc, tc = jax_api.init_cache(cfg, B, S), api.init_cache(cfg, B, S, "cpu")
    if f32:
        jc = jax.tree.map(lambda a: a.astype(jnp.float32), jc)
        tc = {k: v.float() for k, v in tc.items()}
    return jc, tc


def _close(got, want, f32):
    got, want = np32(got), np32(want)
    if f32:
        np.testing.assert_allclose(got, want, rtol=F32_MODEL_TOL, atol=F32_MODEL_TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=MODEL_TOL, atol=MODEL_TOL * float(np.abs(want).max()))


@DTYPES
@pytest.mark.parametrize("enc_frames", ENC_FRAMES)
def test_encode_matches_reference(enc_frames, f32):
    cfg, jparams, tparams, _, frames = _setup(enc_frames, f32=f32)
    jf, tf = _frames(frames, f32)
    want = jax.jit(lambda p, f: jax_encdec.encode(p, cfg, f))(jparams, jf)
    got = encdec.encode(tparams, cfg, tf)
    assert got.shape == (B, enc_frames, cfg.d_model) and got.dtype == tf.dtype
    _close(got, want, f32)


@DTYPES
@pytest.mark.parametrize("enc_frames", ENC_FRAMES)
def test_training_forward_matches_reference(enc_frames, f32):
    """No cache: the decoder rebuilds the cross K/V from the memory."""
    cfg, jparams, tparams, toks, frames = _setup(enc_frames, seed=1, f32=f32)
    jf, tf = _frames(frames, f32)

    def ref(p, f, t):
        return jax_encdec.decode_forward(p, cfg, t, memory=jax_encdec.encode(p, cfg, f))[0]

    want = jax.jit(ref)(jparams, jf, jnp.asarray(toks))
    got, cache = encdec.decode_forward(tparams, cfg, torch.from_numpy(toks).long(),
                                       memory=encdec.encode(tparams, cfg, tf))
    assert cache is None and got.shape == (B, S, cfg.vocab_size)
    _close(got, want, f32)


@DTYPES
@pytest.mark.parametrize("enc_frames", ENC_FRAMES)
def test_prefill_then_decode_matches_reference(enc_frames, f32):
    """Prefill of HALF tokens with the memory, then S - HALF teacher-forced
    decode steps over the caches: logits at every step, the self cache, and
    the cross cache the prefill wrote (its pad slots past enc_frames stay
    zero)."""
    cfg, jparams, tparams, toks, frames = _setup(enc_frames, seed=2, f32=f32)
    jf, tf = _frames(frames, f32)
    jc, tc = _caches(cfg, f32)
    assert tc["cross_k"].shape == (cfg.n_layers, B, transformer.cache_len(enc_frames), cfg.n_kv_heads, cfg.d_head)
    assert all(t.dtype == torch.bfloat16 for t in api.init_cache(cfg, B, S, "cpu").values())
    jpre, jdec = jax.jit(jax_api.prefill_fn(cfg)), jax.jit(jax_api.decode_fn(cfg))
    jl, jc = jpre(jparams, {"tokens": jnp.asarray(toks[:, :HALF]), "frames": jf}, jc, 0)
    tl, tc = api.prefill_fn(cfg)(tparams, {"tokens": torch.from_numpy(toks[:, :HALF]).long(), "frames": tf}, tc, 0)
    _close(tl, jl, f32)
    for name in ("cross_k", "cross_v"):
        _close(tc[name][:, :, :enc_frames], jc[name], f32)
        assert not tc[name][:, :, enc_frames:].any()
    for t in range(HALF, S):
        jl, jc = jdec(jparams, jnp.asarray(toks[:, t:t + 1]), jc, t)
        tl, tc = api.decode_fn(cfg)(tparams, torch.from_numpy(toks[:, t:t + 1]).long(), tc, t)
        assert tl.shape == (B, 1, cfg.vocab_size)
        _close(tl, jl, f32)
    for name in ("self_k", "self_v"):
        _close(tc[name][:, :, :S], jc[name], f32)


@DTYPES
@pytest.mark.parametrize("enc_frames", ENC_FRAMES)
def test_chained_prefill_matches_one_prefill(enc_frames, f32):
    """HALF + HALF tokens, both prefills given the same memory, against one
    prefill of S tokens; the chained logits also against the reference's
    chained prefill."""
    cfg, jparams, tparams, toks, frames = _setup(enc_frames, seed=3, f32=f32)
    jf, tf = _frames(frames, f32)
    t = torch.from_numpy(toks).long()
    pre = api.prefill_fn(cfg)
    full, _ = pre(tparams, {"tokens": t, "frames": tf}, _caches(cfg, f32)[1], 0)
    jc, tc = _caches(cfg, f32)
    _, tc = pre(tparams, {"tokens": t[:, :HALF], "frames": tf}, tc, 0)
    tail, _ = pre(tparams, {"tokens": t[:, HALF:], "frames": tf}, tc, HALF)
    tol = F32_MODEL_TOL if f32 else CHAIN_TOL
    np.testing.assert_allclose(np32(tail), np32(full[:, HALF:]), rtol=tol, atol=tol)
    jpre = jax.jit(jax_api.prefill_fn(cfg), static_argnums=3)
    _, jc = jpre(jparams, {"tokens": jnp.asarray(toks[:, :HALF]), "frames": jf}, jc, 0)
    jtail, _ = jpre(jparams, {"tokens": jnp.asarray(toks[:, HALF:]), "frames": jf}, jc, HALF)
    _close(tail, jtail, f32)


def _labels(toks, seed):
    """Next-token labels with a few positions masked (-1)."""
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    labels[np.random.default_rng(seed).random(labels.shape) < 0.2] = -1
    return labels


@DTYPES
@pytest.mark.parametrize("enc_frames", ENC_FRAMES)
def test_encdec_loss_matches_reference(enc_frames, f32):
    cfg, jparams, tparams, toks, frames = _setup(enc_frames, seed=4, f32=f32)
    jf, tf = _frames(frames, f32)
    labels = _labels(toks, 4)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels), "frames": jf}
    tbatch = {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(labels).long(), "frames": tf}
    want, wparts = jax.jit(lambda p, b: jax_encdec.encdec_loss(p, cfg, b))(jparams, jbatch)
    got, parts = encdec.encdec_loss(tparams, cfg, tbatch)
    assert got.dtype == torch.float32 and got.dim() == 0 and float(parts["aux"]) == 0.0
    tol = F32_LOSS_TOL if f32 else MODEL_TOL
    for g, w in ((got, want), (parts["ce"], wparts["ce"])):
        np.testing.assert_allclose(float(g), float(w), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch,f32", [
    ("qwen3-14b", False),
    # f32: in bf16 a near-tie routing choice may flip between the packages
    ("olmoe-1b-7b", True),
    ("whisper-small", False),
])
def test_loss_fn_matches_reference(arch, f32):
    """``api.loss_fn`` for a dense, an moe (its balance term in the loss)
    and the encdec smoke config."""
    cfg = get_config(arch, smoke=True)
    jparams = jax_api.init_params(cfg, jax.random.key(5))
    if f32:
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    tparams = jax_params_to_torch(jparams, "cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = _labels(toks, 5)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tbatch = {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(labels).long()}
    if cfg.family == "encdec":
        jbatch["frames"], tbatch["frames"] = _frames(rng.standard_normal((B, cfg.enc_frames, cfg.d_model)))
    want, wparts = jax.jit(jax_api.loss_fn(cfg))(jparams, jbatch)
    got, parts = api.loss_fn(cfg)(tparams, tbatch)
    tol = F32_LOSS_TOL if f32 else MODEL_TOL
    for g, w in ((got, want), (parts["ce"], wparts["ce"]), (parts["aux"], wparts["aux"])):
        np.testing.assert_allclose(float(g), float(w), rtol=tol, atol=tol)
    if cfg.family == "moe":
        assert float(parts["aux"]) > 0.0


def test_encdec_loss_gradients_match_reference():
    """On the CPU the loss differentiates through the plain versions: the
    gradients of encoder, cross-attention and embedding leaves against
    ``jax.grad`` of the reference's loss, f32 parameters."""
    cfg, jparams, tparams, toks, frames = _setup(16, seed=6, f32=True)
    jf, tf = _frames(frames, f32=True)
    labels = _labels(toks, 6)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels), "frames": jf}
    tbatch = {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(labels).long(), "frames": tf}
    jgrads = jax.grad(lambda p: jax_encdec.encdec_loss(p, cfg, jbatch)[0])(jparams)
    leaves = [("enc_blocks", "attn", "wq"), ("enc_blocks", "mlp", "w_up"), ("dec_blocks", "cross", "wk"),
              ("dec_blocks", "self_attn", "wv"), ("embed",), ("lm_head",)]

    def get(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    for path in leaves:
        get(tparams, path).requires_grad_(True)
    loss, _ = api.loss_fn(cfg)(tparams, tbatch)
    grads = torch.autograd.grad(loss, [get(tparams, p) for p in leaves])
    for path, g in zip(leaves, grads):
        want = np32(get(jgrads, path))
        scale = float(np.abs(want).max())
        assert scale > 0, path
        np.testing.assert_allclose(np32(g), want, rtol=0, atol=GRAD_TOL * scale, err_msg=str(path))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_config_runs_the_api_on_the_cpu(arch):
    """init_params, init_cache, prefill_fn, decode_fn and loss_fn for each
    of the ten configs at smoke size: finite logits of the right shapes."""
    cfg = get_config(arch, smoke=True)
    params = api.init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 6))).long()
    inputs = {"tokens": toks}
    if cfg.family == "encdec":
        inputs["frames"] = torch_from(rng.standard_normal((1, cfg.enc_frames, cfg.d_model)), torch.bfloat16)
    cache = api.init_cache(cfg, 1, 8, "cpu")
    logits, cache = api.prefill_fn(cfg)(params, inputs, cache, 0)
    assert logits.shape == (1, 6, cfg.vocab_size) and bool(torch.isfinite(logits).all())
    logits, cache = api.decode_fn(cfg)(params, toks[:, -1:], cache, 6)
    assert logits.shape == (1, 1, cfg.vocab_size) and bool(torch.isfinite(logits).all())
    loss, parts = api.loss_fn(cfg)(params, {**inputs, "labels": toks})
    assert bool(torch.isfinite(loss)) and set(parts) == {"ce", "aux"}


def test_calibrate_host_flops_runs_on_smoke_whisper():
    cfg = get_config("whisper-small", smoke=True)
    assert calibrate_host_flops(cfg, n_tokens=16, iters=1, device="cpu") > 0


def test_encdec_prefill_needs_its_frames():
    cfg = get_config("whisper-small", smoke=True)
    params = api.init_params(cfg, 0, "cpu")
    with pytest.raises(ValueError, match="frames"):
        greedy_decode(cfg, params, [1, 2, 3], 2, "cpu")
    wrong = torch.zeros((1, cfg.enc_frames + 1, cfg.d_model), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="enc_frames"):
        api.prefill_fn(cfg)(params, {"tokens": torch.ones((1, 3), dtype=torch.long), "frames": wrong},
                            api.init_cache(cfg, 1, 3, "cpu"), 0)
    tokens, fed, logits = greedy_decode(cfg, params, [1, 2, 3], 2, "cpu",
                                        frames=torch.zeros((1, cfg.enc_frames, cfg.d_model), dtype=torch.bfloat16))
    assert len(tokens) == len(fed) == 2 and logits.shape == (2, cfg.vocab_size)
