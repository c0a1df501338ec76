"""Process start to the first timed request: imports, kernel build or load,
weights made on the device, captures, warm-up and the drain of its writes."""


def read(run):
    return run["setup_s"]
