"""The whole decode step's share of the chip's peak: for each step the
least time of ``roofline.decode_step`` (the larger of FLOPs over the bf16
peak and bytes over HBM bandwidth), summed over the window's steps, over
the window's decode time, in percent.  A request that carried the device
trace (``--trace 1``) is left out: the profiler stretches its steps."""


def read(run):
    r = [x for x in run["requests"] if not x.get("profiled")]
    secs = sum(x["decode_s"] for x in r)
    return float(len(r) * run["decode_bound_s"] / secs * 100.0) if secs else None
