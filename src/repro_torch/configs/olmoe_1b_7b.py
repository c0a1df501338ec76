"""OLMoE-1B-7B — 64-expert top-8 MoE [arXiv:2409.02060; hf]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    n_experts=64,
    experts_per_token=8,
    moe_d_ff=1024,
    qk_norm=True,  # OLMoE uses QK-norm
    source="arXiv:2409.02060; hf:allenai/OLMoE-1B-7B-0924",
)
