"""Mean seconds of the cache's fetch (store probe and batched get, on the
I/O executor) over the fetches the window's requests needed, timed by the
benchmark around ``CacheHierarchy.fetch``."""


def read(run):
    f = run["fetch_s"]
    return float(sum(f) / len(f) * 1e3) if f else None
