"""Qwen2.5-32B — dense GQA with QKV bias [hf:Qwen/Qwen2.5-32B]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    source="hf:Qwen/Qwen2.5-32B (family config per assignment)",
)
