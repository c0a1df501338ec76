"""The prefill's FLOPs (from shapes, ``kvbench/roofline.prefill_flops``)
over its measured ``compute_s`` at the H100's bf16 peak, in percent."""

from kvbench import roofline


def read(run):
    r = run["requests"]
    secs = sum(x["compute_s"] for x in r)
    return float(len(r) * run["prefill_flops"] / (secs * roofline.PEAK_FLOPS_BF16) * 100.0) if secs else None
