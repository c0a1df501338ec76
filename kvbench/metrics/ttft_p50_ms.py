"""Median TTFT over every request completed in the window, each timed from
the client's submit to the return of the step that served it (host clock)."""

import numpy as np


def read(run):
    t = [r["ttft_s"] for r in run["requests"]]
    return float(np.percentile(t, 50) * 1e3) if t else None
