"""How the launches of a replayed CUDA graph are counted.  A replay runs no
wrapper, so a device trace counts them by the kernels' ``__global__``
names (``repro_torch.kernels.TRACE_SYMBOLS``).  Here, on the CPU: every
name is a kernel of its wrapper's source, the wrapper launches exactly
one of them per call, and ``traced_launch_counts`` maps the names
torch.profiler prints to the wrappers.  The trace itself is read on the
card (``tests/test_torch_cuda_steps.py``, chip_smoke.py phase ``steps``)."""

import re
from pathlib import Path

import pytest

from repro_torch import graphs, kernels
from repro_torch.kernels import TRACE_SYMBOLS, traced_launch_counts

KERNELS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
SOURCES = {"flash": "flash_attention/csrc/flash_attention.cu",
           "paged_decode": "decode_attention/csrc/decode_attention.cu",
           "wkv": "rwkv6/csrc/rwkv6.cu", "ssd": "mamba2/csrc/mamba2.cu",
           "quantize": "kv_codec/csrc/kv_codec.cu", "dequantize": "kv_codec/csrc/kv_codec.cu",
           "sq_norm": "adamw/csrc/adamw.cu", "adamw_update": "adamw/csrc/adamw.cu",
           "factored_stats": "adamw/csrc/adamw.cu"}


def _globals(src: str):
    """The names of the ``__global__`` functions of a CUDA source."""
    return set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", src))


@pytest.mark.parametrize("kernel", sorted(TRACE_SYMBOLS))
def test_trace_symbols_are_kernels_of_their_wrappers_source(kernel):
    src = (KERNELS / SOURCES[kernel]).read_text()
    assert set(TRACE_SYMBOLS[kernel]) <= _globals(src)
    # each symbol is launched at one site, and no other kernel's symbol is in the source
    for symbol in TRACE_SYMBOLS[kernel]:
        sites = re.findall(r"\b" + symbol + r"\b(?:<[^;]*?>)?\s*<<<", src)
        aliased = re.findall(r"auto\s+(\w+)\s*=\s*(?:\w+::)?" + symbol + r"\b", src)
        assert len(sites) + len(aliased) == 1, (symbol, sites, aliased)


def test_every_counted_kernel_has_trace_symbols():
    assert set(TRACE_SYMBOLS) == set(kernels.launch_counts())
    symbols = [s for group in TRACE_SYMBOLS.values() for s in group]
    assert len(symbols) == len(set(symbols))


def test_traced_launch_counts_reads_profiler_names():
    runs = [("void (anonymous namespace)::tc::flash_bf16_kernel<128, 128>(__nv_bfloat16 const*, int)", 40),
            ("void (anonymous namespace)::flash_fwd_kernel<float, 64, 64>(float const*, int)", 2),
            ("void (anonymous namespace)::tc::paged_decode_mma_kernel<128>(__nv_bfloat16 const*)", 40),
            ("void (anonymous namespace)::paged_decode_join_kernel<__nv_bfloat16>(float const*)", 40),
            ("void (anonymous namespace)::wkv_group_kernel<__nv_bfloat16>(float*)", 24),
            ("void (anonymous namespace)::ssd_local_kernel<__nv_bfloat16>(float*)", 38),
            ("void dequantize_kernel<float, 4>(signed char const*)", 3),
            ("void quantize_absmax_kernel<__nv_bfloat16, 8>(float*)", 1),
            ("nvjet_tst_192x128_64x5_4x1_v_bz_coopB_NNT", 80),
            ("Memcpy DtoD (Device -> Device)", 81),
            ("void (anonymous namespace)::sq_norm_partial_kernel<__nv_bfloat16, true>(__nv_bfloat16 const*)", 14),
            ("(anonymous namespace)::sq_norm_join_kernel(double const*, int, double*, long)", 14),
            ("void (anonymous namespace)::adamw_update_kernel<__nv_bfloat16, float, false, true>(float*)", 14),
            ("void (anonymous namespace)::factored_partial_kernel<__nv_bfloat16, true>(double*)", 13),
            ("(anonymous namespace)::factored_finish_kernel(double const*, double const*)", 13)]
    assert traced_launch_counts(runs) == {"flash": 42, "paged_decode": 40, "wkv": 0, "ssd": 38,
                                          "quantize": 1, "dequantize": 3,
                                          "sq_norm": 14, "adamw_update": 14, "factored_stats": 13}


def test_capture_lives_below_serving_and_launch():
    """``serving`` and ``launch`` both capture their steps: the capture is
    in ``repro_torch.graphs``, which imports neither."""
    from repro_torch.launch import steps

    src = Path(graphs.__file__).read_text()
    assert steps.capture is graphs.capture
    assert not re.search(r"from \.(launch|serving|training)\b", src)
