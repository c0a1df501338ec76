"""Share of the window's hit tokens that came from the disk tier
(``CacheStats.tokens_hit_disk`` over all hit tokens), in percent."""


def read(run):
    c = run["cache"]
    hit = c["tokens_hit_device"] + c["tokens_hit_host"] + c["tokens_hit_disk"]
    return float(c["tokens_hit_disk"] / hit * 100.0) if hit else None
