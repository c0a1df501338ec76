"""The flash kernels' bound from shapes (``roofline.flash_call``, each call
one launch) over their device time in the traced sub-window, in percent."""

from kvbench import roofline


def read(run):
    prof = run.get("profile")
    if not prof:
        return None
    n, secs = prof["kernels"]["flash"]
    if not n or not secs:
        return None
    return float(n * roofline.bound_s(*run["flash_call"])[0] / secs * 100.0)
