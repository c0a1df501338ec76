"""Zamba2-1.2B — Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf:Zyphra/Zamba2-1.2B]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_head=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_heads=64,  # d_inner(4096) / 64
    expand=2,
    d_conv=4,
    attn_every=6,  # shared transformer block applied every 6 mamba layers
    source="arXiv:2411.15242; hf",
    notes="mamba2 state snapshots + shared-attn token KV both stored under prefix keys",
)
