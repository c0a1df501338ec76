"""The port's serving path against the reference: the real-prefill hook's
blocks (stored layout, float16, F-order) and the whole serve run on the
CPU, whose per-request reuse must equal the reference engine's on the same
workload."""

import jax
import numpy as np
import pytest
import torch
from parity_harness import jax_engine_reuse, jax_params_to_torch, jax_real_prefill

from repro.configs import get_config
from repro.models import api as jax_api
from repro_torch.launch import serve_e2e
from repro_torch.serving import calibrate_host_flops
from repro_torch.serving.real_prefill import fortran_blocks, make_real_prefill

BLOCK = 16


@pytest.fixture(scope="module")
def smoke():
    cfg = get_config("qwen3-14b", smoke=True)
    jparams = jax_api.init_params(cfg, jax.random.key(0))
    return cfg, jparams, jax_params_to_torch(jparams, "cpu")


def test_fortran_blocks_match_numpy_order_f():
    """Torch has no order="F"; the permute/reshape/transpose form equals
    numpy's ``reshape(block, -1, order="F")`` block by block."""
    x = np.random.default_rng(0).standard_normal((3, 2 * BLOCK, 2, 5)).astype(np.float32)
    got = fortran_blocks(torch.from_numpy(x), BLOCK).numpy()
    for i in range(2):
        want = x[:, i * BLOCK:(i + 1) * BLOCK].reshape(BLOCK, -1, order="F")
        np.testing.assert_array_equal(got[i], want)


@pytest.mark.parametrize("reused", [0, 48])
def test_real_prefill_blocks_match_reference_hook(smoke, reused):
    """Same tokens and params: the blocks are (BLOCK, 2·L·KVH·Dh) float16,
    k then v, allclose to the reference hook's (both come from bf16 caches
    computed by two frameworks; one bf16 step of the cache is 2^-8 relative)."""
    cfg, jparams, tparams = smoke
    tokens = np.random.default_rng(1).integers(0, 50_000, 128).tolist()  # ids past V, as served
    want, _ = jax_real_prefill(cfg, jparams, BLOCK)(tokens, reused)
    hook = make_real_prefill(cfg, tparams, BLOCK, "cpu", lengths=(128,))
    got, seconds = hook(tokens, reused)
    assert hook.calls == 1 and seconds > 0
    assert len(got) == len(want) == (128 - reused) // BLOCK
    width = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.d_head
    for g, w in zip(got, want):
        assert g.dtype == np.float16 and g.shape == w.shape == (BLOCK, width)
        np.testing.assert_allclose(g.astype(np.float32), w.astype(np.float32), rtol=3e-2, atol=3e-2)


def test_real_prefill_refuses_a_length_it_was_not_built_for(smoke):
    """The hook's steps are built (captured, on the card) when the hook is
    made, before the engine runs: a prompt of another length raises
    instead of building a step inside the engine's run loop."""
    cfg, _, tparams = smoke
    hook = make_real_prefill(cfg, tparams, BLOCK, "cpu", lengths=(32,))
    assert sorted(hook.steps) == [32]
    with pytest.raises(ValueError, match="lengths it was built for"):
        hook(list(range(48)), 0)
    assert hook.calls == 0
    blocks, _ = hook(list(range(32)), 16)
    assert hook.calls == 1 and len(blocks) == 1


def test_serve_e2e_reuse_matches_reference_engine(smoke):
    """A reduced run of the serve workload on the CPU: every request reuses
    exactly the tokens the reference engine, fed by the reference hook,
    reuses on the same workload; stages with expected hits do hit."""
    cfg, jparams, _ = smoke
    res = serve_e2e.main(smoke=True, device="cpu", corpus_size=4, requests_per_stage=2, verbose=False)
    want = jax_engine_reuse(cfg, jparams, corpus_size=4, requests_per_stage=2)
    assert res["requests"] == want
    assert [s["hit"] > 0 for s in res["stages"]] == [False, True, True]
    assert res["prefills"] == 4 + 3 * 2 + 1
    assert len(res["decoded"]) == serve_e2e.DECODE_TOKENS
    assert bool(torch.isfinite(res["decode_logits"]).all())


def test_serve_e2e_refuses_a_missing_card():
    """Entry points run on the card unless the CPU is asked for: with no
    CUDA device the default raises instead of running on the CPU."""
    import inspect

    assert inspect.signature(serve_e2e.main).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert serve_e2e.resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_e2e.main()


def test_calibrate_host_flops_times_the_ports_prefill():
    cfg = get_config("qwen3-14b", smoke=True)
    flops = calibrate_host_flops(cfg, n_tokens=32, iters=1, device="cpu")
    assert np.isfinite(flops) and flops > 0
