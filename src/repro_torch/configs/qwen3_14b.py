"""Qwen3-14B — dense GQA with QK-norm [hf:Qwen/Qwen3-14B]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    source="hf:Qwen/Qwen3-14B (family config per assignment)",
)
