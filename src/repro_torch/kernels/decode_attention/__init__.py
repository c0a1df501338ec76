from .ops import HEAD_DIMS, design, kv_page_strides, page_strides, paged_decode, paged_decode_ref, split_plan  # noqa: F401
