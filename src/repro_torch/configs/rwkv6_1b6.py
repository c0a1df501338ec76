"""RWKV-6 'Finch' 1.6B — attention-free, data-dependent decay
[arXiv:2404.05892; unverified]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="rwkv6",
    n_layers=24,
    d_model=2048,
    n_heads=32,  # wkv heads: d_model / 64
    n_kv_heads=32,
    d_head=64,
    d_ff=7168,
    vocab_size=65536,
    attention="none",
    ssm_state=64,
    source="arXiv:2404.05892",
    notes="constant-size recurrent state; long_500k eligible",
)
