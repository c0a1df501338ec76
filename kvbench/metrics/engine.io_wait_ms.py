"""Mean ``RequestRecord.io_wait_s`` over the window's requests: the I/O the
engine's two-stage pipeline could not hide."""


def read(run):
    r = run["requests"]
    return float(sum(x["io_wait_s"] for x in r) / len(r) * 1e3) if r else None
