"""Bytes the process wrote in the window (``wchar`` of /proc/self/io: the
store's logs, indexes and compactions) over the float16 KV bytes the
write-behind committed in it."""


def read(run):
    committed = run["commit"]["completed_bytes"]
    if run["wchar"] is None or not committed:
        return None
    return float(run["wchar"] / committed)
