"""All decode time in the window over all decode steps in it: each request
from the end of its prefill (device synchronised) to the return of its last
token; the prefill's time is left out (host clock)."""


def read(run):
    steps = sum(r["steps"] for r in run["requests"])
    return float(sum(r["decode_s"] for r in run["requests"]) / steps * 1e3) if steps else None
