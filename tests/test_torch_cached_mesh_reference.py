"""The port's cached forward under a (data, model) mesh against the JAX
package's sharded serve steps, on the CPU.

The reference jits ``launch/steps.build_decode_step`` with
``decode_shardings`` under ``make_smoke_mesh`` (``src/repro/launch/
steps.py:104-127``, ``launch/mesh.py:24``), here on 4 JAX host devices in
a subprocess, at (data, model) = (1, 2) and (2, 2); the port runs the same
steps on 2 and 4 gloo ranks under ``tensor_parallel`` (the kernels'
wrappers, which take their plain versions on CPU tensors,
``tests/dist_harness.cached_steps_ranks``), each rank on its rows of the
batch.  Both start from the same f32 parameters, the reference's
``init_params(cfg, jax.random.key(0))`` cast to f32, and the same seeded
tokens, for the smoke configs dense, moe and MLA of
``dist_harness.tp_config``.  A prefill of S tokens, then N_STEPS greedy
decode steps.

The prefill is ``build_prefill_step``'s body on both sides (``prefill_fn``
at 0 into a fresh cache of S + N_STEPS slots, the last token's logits),
jitted with ``prefill_shardings``, with its cache in f32: the reference's
step allocates a bf16 cache, into which its ``dynamic_update_slice``
refuses f32 K/V.

Tolerance: CACHED_TOL, atol = rtol 1e-5, ``tests/test_torch_tensor_parallel.py``'s
for the cached forward in f32: the splits sum each rank's partial products
over ``model`` in another order than XLA's sharded program, so the logits
differ in summation order only, and an entry near zero carries the
summation noise of terms of order 1.  The greedy tokens are equal.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import dist_harness as dh

SRC = Path(__file__).resolve().parents[1] / "src"
CACHED_TOL = 1e-5
CASES = ("dense", "moe", "mla")
SHAPES = [(1, 2), (2, 2)]
B, S, N_STEPS = 2, 8, 2

JAX_STEPS = textwrap.dedent("""
    import os, sys, json, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config
    from repro.configs.base import ShapeConfig
    from repro.launch import steps
    from repro.launch.mesh import make_smoke_mesh
    from repro.models import api

    cases, shapes = json.loads(sys.argv[2]), json.loads(sys.argv[3])
    B, S, N = (int(a) for a in sys.argv[4:7])
    f32 = lambda tree: jax.tree.map(lambda a: a.astype(jnp.float32), tree)
    out = {}
    for case, (arch, over) in cases.items():
        cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
        params = f32(api.init_params(cfg, jax.random.key(0)))
        for path, a in jax.tree_util.tree_flatten_with_path(params)[0]:
            out[f"{case}|p|" + "/".join(k.key for k in path)] = np.asarray(a)
        tokens = np.random.default_rng(11).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        out[f"{case}|tokens"] = tokens
        shape, dshape = ShapeConfig("serve", S + N, B, "prefill"), ShapeConfig("serve", S + N, B, "decode")

        def prefill_step(params, inputs):  # build_prefill_step's body, the cache in f32
            cache = f32(api.init_cache(cfg, B, S + N))
            logits, cache = api.prefill_fn(cfg)(params, inputs, cache, 0)
            return logits[:, -1, :], cache

        for data, model in shapes:
            mesh = make_smoke_mesh(data, model)
            with mesh:
                p_in, p_out = steps.prefill_shardings(mesh, cfg, shape)
                prefill = jax.jit(prefill_step, in_shardings=p_in, out_shardings=p_out)
                d_in, d_out = steps.decode_shardings(mesh, cfg, dshape)
                decode = jax.jit(steps.build_decode_step(cfg, dshape), in_shardings=d_in, out_shardings=d_out)
                logits, cache = prefill(params, {"tokens": jnp.asarray(tokens)})
                key = f"{case}|{data}x{model}"
                for i in range(N + 1):
                    out[f"{key}|logits{i}"] = np.asarray(logits)
                    if i == N:
                        break
                    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
                    out[f"{key}|tokens{i}"] = np.asarray(tok)
                    logits, cache = decode(params, tok, cache, jnp.int32(S + i))
    np.savez(sys.argv[1], **out)
    print("JAX_OK")
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's sharded prefill and greedy decode steps of every
    case on both meshes, with the parameters and tokens it drew."""
    root = tmp_path_factory.mktemp("cached_mesh_jax")
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", JAX_STEPS, str(root / "ref.npz"),
                        json.dumps({c: dh.TP_CASES[c] for c in CASES}), json.dumps(SHAPES),
                        str(B), str(S), str(N_STEPS)], capture_output=True, text=True, env=env, timeout=240)
    assert r.returncode == 0 and "JAX_OK" in r.stdout, r.stderr[-3000:]
    return str(root / "ref.npz")


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """The port's steps on 2 gloo ranks at (1, 2) and on 4 at (2, 2)."""
    root = tmp_path_factory.mktemp("cached_mesh_ranks")
    return {(data, model): dh.run_ranks(dh.cached_steps_ranks, data * model, str(root / f"{data}x{model}"),
                                        reference, CASES, data, N_STEPS)
            for data, model in SHAPES}


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"data{s[0]}_model{s[1]}")
@pytest.mark.parametrize("case", CASES)
def test_cached_steps_equal_the_references_under_its_mesh(case, shape, reference, ranks):
    """Each rank's whole logits of the prefill and of every decode step,
    for its rows, and its greedy tokens, are the reference's."""
    ref = dict(np.load(reference))
    key = f"{case}|{shape[0]}x{shape[1]}"
    covered = set()
    for got in ranks[shape]:
        res = got[case]
        lo, hi = res["rows"]
        covered |= set(range(lo, hi))
        assert len(res["logits"]) == N_STEPS + 1 and len(res["tokens"]) == N_STEPS
        for i, logits in enumerate(res["logits"]):
            np.testing.assert_allclose(logits.numpy(), ref[f"{key}|logits{i}"][lo:hi], rtol=CACHED_TOL,
                                       atol=CACHED_TOL, err_msg=f"{key} step {i}")
        for i, tok in enumerate(res["tokens"]):
            np.testing.assert_array_equal(tok.numpy(), ref[f"{key}|tokens{i}"][lo:hi], err_msg=f"{key} token {i}")
    assert covered == set(range(B))
