from .ops import (  # noqa: F401
    dequantize,
    dequantize_plan,
    dequantize_ref,
    plan_for_dequantize,
    plan_for_quantize,
    quantize,
    quantize_plan,
    quantize_ref,
    quantize_slabs_plain,
    vector_aligned,
)
