"""Share of the window the engine spent blocked on the write-behind queue's
backpressure (``CommitQueueStats.stall_s`` over the window), in percent."""


def read(run):
    return float(run["commit"]["stall_s"] / run["window_s"] * 100.0)
