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
        cfg = get_config("qwen3-14b", smoke=True)
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


def test_no_module_of_the_port_names_jax_or_the_reference():
    for path in (SRC / "repro_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                assert "jax" not in stripped and "repro." not in stripped.replace("repro_torch", ""), \
                    f"{path}: {stripped}"


def test_kernel_build_command_targets_hopper():
    assert _build.kernel_names() == ["decode_attention", "flash_attention"]
    for name in _build.kernel_names():
        assert _build.source_path(name).exists()
        lib = _build.library_path(name)
        assert lib.parent == _build.BUILD_DIR and lib.name.startswith(f"lib{name}_")
    flags = _build.NVCC_FLAGS
    assert flags[:2] == ["-gencode", "arch=compute_90a,code=sm_90a"]
    assert {"-O3", "-shared", "-std=c++17"} <= set(flags)


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

    reset_launch_counts()
    q = torch.zeros(1, 4, 2, 16)
    flash_attention(q, q, q)
    paged_decode(torch.zeros(1, 2, 16), torch.zeros(2, 4, 2, 16), torch.zeros(2, 4, 2, 16),
                 torch.zeros(1, 2, dtype=torch.int32), torch.ones(1, dtype=torch.int32))
    assert launch_counts() == {"flash": 0, "paged_decode": 0}  # CPU tensors take the plain versions
