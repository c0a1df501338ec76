"""The write-behind drain thread's seconds applying commits to the store
(encode, log, index) in the window, per KV block it drained."""


def read(run):
    blocks = run["commit"]["completed_bytes"] / run["block_bytes"]
    return float(run["commit"]["drain_s"] / blocks * 1e3) if blocks else None
