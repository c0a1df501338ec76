from .ops import dequantize, dequantize_ref, quantize, quantize_ref  # noqa: F401
