from .ops import paged_decode, paged_decode_ref  # noqa: F401
