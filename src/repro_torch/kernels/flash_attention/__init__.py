from .ops import attention_ref, design, flash_attention, flash_attention_full, flash_attention_plain  # noqa: F401
