from .ops import attention_ref, flash_attention, flash_attention_plain  # noqa: F401
