from .ops import design, wkv, wkv_chunked_plain, wkv_model, wkv_ref  # noqa: F401
