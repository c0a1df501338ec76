from .api import decode_fn, init_cache, init_params, prefill_fn  # noqa: F401
