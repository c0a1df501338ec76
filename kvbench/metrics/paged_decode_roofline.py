"""The paged decode kernels' bound from shapes, summed over the traced
decode steps (``roofline.paged_decode_call`` at each step's kv length,
every layer), over the device time of their split and join kernels, in
percent.  The traffic file places the traced steps (``profile_steps``,
counted over the window's requests) in its second request: the first
request of a process idles more (PERF.md §6)."""


def read(run):
    prof = run.get("profile")
    if not prof or not run.get("paged_decode_bound_s"):
        return None
    secs = prof["kernels"]["paged_decode"][1]
    return float(run["paged_decode_bound_s"] / secs * 100.0) if secs else None
