"""Share of the traced sub-window in which no operation ran on the device
(the union of the profiler's device operations), in percent."""


def read(run):
    prof = run.get("profile")
    if not prof or not prof["window_s"]:
        return None
    return float((1.0 - prof["busy_s"] / prof["window_s"]) * 100.0)
