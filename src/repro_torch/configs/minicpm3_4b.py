"""MiniCPM3-4B — dense with Multi-head Latent Attention (MLA)
[hf:openbmb/MiniCPM3-4B]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    attention="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_rope_dim=32,
    qk_nope_dim=64,
    v_head_dim=64,
    source="hf:openbmb/MiniCPM3-4B",
    notes="MLA: disk store caches the compressed latent (kv_lora+rope) per token",
)
