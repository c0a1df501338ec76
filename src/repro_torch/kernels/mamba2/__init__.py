from .ops import design, ssd, ssd_chunked, ssd_chunked_plain, ssd_ref  # noqa: F401
