"""The port stands alone: every module under ``repro_torch`` imports, and a
smoke prefill runs on the CPU, with ``jax``, ``repro`` and ``ml_dtypes``
blocked.  Also the kernel build's command line and its refusal to fall
back when no CUDA toolkit is there."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.kernels import _build, launch_counts, reset_launch_counts

SRC = Path(__file__).resolve().parents[1] / "src"


def test_port_imports_and_prefills_with_jax_and_repro_blocked():
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "repro", "ml_dtypes"):
            sys.modules[name] = None   # any import of these now raises
        import importlib, pkgutil
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
        for n in names:
            importlib.import_module(n)
        assert not any(k == "jax" or k.startswith(("jax.", "repro.")) for k in sys.modules
                       if sys.modules[k] is not None)
        import torch
        from repro_torch.configs import get_config
        from repro_torch.models import api
        for arch in ("qwen3-14b", "rwkv6-1.6b", "zamba2-1.2b", "olmoe-1b-7b", "minicpm3-4b"):
            cfg = get_config(arch, smoke=True)
            params = api.init_params(cfg, 0, "cpu")
            logits, cache = api.prefill_fn(cfg)(params, {"tokens": torch.arange(8)[None]},
                                                api.init_cache(cfg, 1, 8, "cpu"), 0)
            assert logits.shape == (1, 8, cfg.vocab_size) and bool(torch.isfinite(logits.float()).all())
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[-1]) >= 40  # every copied and ported module


def test_training_runs_with_jax_repro_and_ml_dtypes_blocked(tmp_path):
    """``repro_torch.training`` and ``repro_torch.launch.train`` import and
    run on the CPU with ``jax``, ``repro`` and ``ml_dtypes`` blocked: the
    launcher trains qwen3-14b-smoke for 3 steps with a checkpoint at step
    2, then a second launch resumes from it (restore reads the bf16
    leaves without ml_dtypes)."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "repro", "ml_dtypes"):
            sys.modules[name] = None
        import repro_torch.training, repro_torch.training.optim, repro_torch.training.checkpoint
        from repro_torch.launch.train import main
        argv = ["--steps", "3", "--ckpt-every", "2", "--ckpt-dir", {str(tmp_path)!r}, "--device", "cpu"]
        first = main(argv)
        again = main(["--steps", "4"] + argv[2:])
        assert first["resumed_from"] == 0 and len(first["losses"]) == 3
        assert again["resumed_from"] == 3 and len(again["losses"]) == 1
        assert not any(k == "jax" or k.startswith(("jax.", "repro.", "ml_dtypes")) for k in sys.modules
                       if sys.modules[k] is not None)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-1] == "ok"


def test_launch_modules_run_with_jax_repro_and_benchmarks_blocked(tmp_path):
    """``launch.steps``, ``launch.serve`` and ``launch.mesh`` import and run
    on the CPU with ``jax``, ``repro``, ``benchmarks`` and ``ml_dtypes``
    blocked: a captured prefill and decode step (the steps themselves on
    the CPU) and the serve launcher over a small staged workload."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "repro", "benchmarks", "ml_dtypes"):
            sys.modules[name] = None
        import torch
        from repro_torch.configs import get_config
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch import mesh, serve, steps
        from repro_torch.models import api
        cfg = get_config("glm4-9b", smoke=True)
        params = api.init_params(cfg, 0, "cpu")
        toks = {{"tokens": torch.arange(8)[None]}}
        pre = steps.capture(steps.build_prefill_step(cfg, ShapeConfig("p", 9, 1, "prefill")), params, toks, held=(0,))
        logits, cache = pre(params, toks)
        dec = steps.build_decode_step(cfg, ShapeConfig("d", 9, 1, "decode"))
        logits, cache = dec(params, logits.argmax(-1, keepdim=True), cache, torch.tensor(8, dtype=torch.int32))
        assert logits.shape == (1, cfg.vocab_size) and bool(torch.isfinite(logits.float()).all())
        res = serve.main(["--prompt-len", "64", "--requests", "4", "--stages", "0.2,0.5", "--root", {str(tmp_path)!r}])
        assert [r.stage for r in res] == [0, 1] and mesh.HBM_BW == 3.35e12
        assert not any(k == "jax" or k.startswith(("jax.", "repro.", "benchmarks", "ml_dtypes")) for k in sys.modules
                       if sys.modules[k] is not None)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-1] == "ok"


def test_distributed_layer_runs_with_jax_repro_and_ml_dtypes_blocked(tmp_path):
    """``repro_torch.distributed`` and ``launch.mesh`` import and run on the
    CPU with ``jax``, ``repro`` and ``ml_dtypes`` blocked, in a gloo group
    of world size 1: the (1, 1) smoke mesh, qwen3-14b-smoke's parameters
    placed under their shardings, the compressed all-reduce (at one rank,
    dequant(q) itself), gpipe at one stage, a checkpoint restored under the
    shardings, and the rules reckoned for the 256-card production mesh."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "repro", "ml_dtypes"):
            sys.modules[name] = None
        import torch, torch.distributed as dist
        from repro_torch.configs import get_config
        from repro_torch.distributed import compression as cmp, sharding as shd
        from repro_torch.distributed.pipeline import gpipe
        from repro_torch.launch import mesh as meshes
        from repro_torch.models import api
        from repro_torch.models.common import tree_flatten
        from repro_torch.training import checkpoint as ckpt
        cfg = get_config("qwen3-14b", smoke=True)
        big = shd.param_shardings(shd.AbstractMesh((16, 16), ("data", "model")), api.param_specs(get_config("qwen3-14b")))
        assert big["blocks"]["attn"]["wq"].spec == shd.P(None, "data", "model")
        assert meshes.init_process_group("cpu")
        try:
            mesh = meshes.make_smoke_mesh(1, 1, device="cpu")
            params = api.init_params(cfg, 0, "cpu")
            shs = shd.param_shardings(mesh, params)
            placed = shd.place(params, shs)
            assert all(torch.equal(a.to_local(), b) for a, b in zip(tree_flatten(placed)[0], tree_flatten(params)[0]))
            g = {{"w": torch.linspace(-1, 1, 12).reshape(3, 4)}}
            red, res = cmp.allreduce_compressed(mesh, g, cmp.init_residuals(g))
            q, s, _ = cmp.compress_grads(g, cmp.init_residuals(g))
            assert torch.equal(red["w"], cmp.dequantize_tensor(q["w"], s["w"]))
            pm = torch.distributed.device_mesh.init_device_mesh("cpu", (1,), mesh_dim_names=("stage",))
            xs = torch.ones(3, 2, 4)
            assert torch.equal(gpipe(lambda p, x: x @ p, pm)(torch.eye(4)[None], xs), xs)
            ckpt.save({str(tmp_path)!r}, 1, params)
            got, _ = ckpt.restore({str(tmp_path)!r}, 1, params, shs)
            assert all(torch.equal(a.full_tensor(), b) for a, b in zip(tree_flatten(got)[0], tree_flatten(params)[0]))
        finally:
            dist.destroy_process_group()
        assert not any(k == "jax" or k.startswith(("jax.", "repro.", "ml_dtypes")) for k in sys.modules
                       if sys.modules[k] is not None)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-1] == "ok"


def test_dry_run_tools_run_with_jax_repro_and_benchmarks_blocked(tmp_path):
    """``launch.cost``, ``launch.steps.lower_cell``, ``launch.dryrun``,
    ``launch.roofline`` and ``launch.micro`` import and run on the CPU
    with ``jax``, ``repro``, ``benchmarks`` and ``ml_dtypes`` blocked: one
    smoke cell traced at (16, 16) and written, the roofline table read
    back, a matmul counted, and the micro-benchmarks' byte counts."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "repro", "benchmarks", "ml_dtypes"):
            sys.modules[name] = None
        import torch
        from repro_torch.launch import cost, dryrun, micro, roofline
        rec = dryrun.run_cell("glm4-9b", "decode_32k", 1, smoke=True, root={str(tmp_path)!r})
        assert rec["ok"] and rec["roofline"]["bottleneck"] == "memory"
        rows = roofline.load_cells(1, smoke=True, root={str(tmp_path)!r})
        assert sum(bool(r.get("ok")) for r in rows) == 1
        _, t = cost.count(torch.matmul, torch.empty(4, 8, device="meta"), torch.empty(8, 2, device="meta"))
        assert t.matmul_flops == 2 * 4 * 8 * 2
        recs = micro.run("cpu", verbose=False)
        assert [r["name"] for r in recs] == ["flash", "paged_decode", "quantize", "dequantize", "wkv", "ssd"]
        assert all(r["oracle_hbm_bytes"] > r["kernel_hbm_bytes"] > 0 and "kernel_ms" not in r for r in recs)
        assert not any(k == "jax" or k.startswith(("jax.", "repro.", "benchmarks", "ml_dtypes")) for k in sys.modules
                       if sys.modules[k] is not None)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=180)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-1] == "ok"


def test_no_module_of_the_port_names_jax_or_the_reference():
    for path in (SRC / "repro_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                assert "jax" not in stripped and "repro." not in stripped.replace("repro_torch", ""), \
                    f"{path}: {stripped}"


def test_kernel_build_command_targets_hopper():
    assert _build.kernel_names() == ["decode_attention", "flash_attention", "kv_codec", "mamba2", "rwkv6"]
    for name in _build.kernel_names():
        assert _build.source_path(name).exists()
        lib = _build.library_path(name)
        assert lib.parent == _build.BUILD_DIR and lib.name.startswith(f"lib{name}_")
    flags = _build.NVCC_FLAGS
    assert flags[:2] == ["-gencode", "arch=compute_90a,code=sm_90a"]
    assert {"-O3", "-shared", "-std=c++17"} <= set(flags)


def test_kernel_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    """Every source includes kernels/include/kernel_common.cuh, so an edit
    to that header must rename (and so rebuild) every library."""
    assert (_build.INCLUDE_DIR / "kernel_common.cuh").exists()
    for name in _build.kernel_names():
        assert '#include "kernel_common.cuh"' in _build.source_path(name).read_text()
    before = {n: _build.library_path(n) for n in _build.kernel_names()}
    (tmp_path / "kernel_common.cuh").write_text((_build.INCLUDE_DIR / "kernel_common.cuh").read_text() + "// edit\n")
    monkeypatch.setattr(_build, "INCLUDE_DIR", tmp_path)
    after = {n: _build.library_path(n) for n in _build.kernel_names()}
    assert all(before[n] != after[n] for n in before)


def test_kernel_build_raises_without_a_toolkit():
    """No nvcc, no kernel: the build raises rather than handing back the
    plain version."""
    try:
        _build.nvcc_path()
    except RuntimeError:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build_all(["flash_attention"])
    else:
        pytest.skip("this host has a CUDA toolkit: the kernels are built and checked by chip_smoke.py")


def test_launch_counters_count_only_kernel_launches():
    import torch

    from repro_torch.kernels.decode_attention import paged_decode
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.kv_codec import dequantize, quantize
    from repro_torch.kernels.mamba2 import ssd
    from repro_torch.kernels.rwkv6 import wkv_model

    reset_launch_counts()
    q = torch.zeros(1, 4, 2, 16)
    flash_attention(q, q, q)
    paged_decode(torch.zeros(1, 2, 16), torch.zeros(2, 4, 2, 16), torch.zeros(2, 4, 2, 16),
                 torch.zeros(1, 2, dtype=torch.int32), torch.ones(1, dtype=torch.int32))
    wkv_model(q, q, q, torch.ones(1, 4, 2, 16), torch.zeros(2, 16), torch.zeros(1, 2, 16, 16))
    ssd(q, torch.zeros(1, 4, 8), torch.zeros(1, 4, 8), torch.ones(1, 4, 2), torch.zeros(1, 4, 2),
        torch.zeros(1, 2, 16, 8))
    dequantize(*quantize(q))
    # CPU tensors take the plain versions
    assert launch_counts() == {"flash": 0, "paged_decode": 0, "wkv": 0, "ssd": 0, "quantize": 0, "dequantize": 0}
