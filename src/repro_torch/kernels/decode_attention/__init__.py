from .ops import design, paged_decode, paged_decode_ref, split_plan  # noqa: F401
