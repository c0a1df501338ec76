"""Mean ``RequestRecord.compute_s``: the hook's replay of the captured
prefill and its copy-out, ended by a device synchronise (host clock)."""


def read(run):
    r = run["requests"]
    return float(sum(x["compute_s"] for x in r) / len(r) * 1e3) if r else None
