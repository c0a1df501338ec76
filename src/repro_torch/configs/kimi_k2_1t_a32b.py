"""Kimi K2 — trillion-parameter MoE, 384 experts top-8 (paper-table dims)
[arXiv:2501.kimi2; unverified]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    n_experts=384,
    experts_per_token=8,
    moe_d_ff=2048,
    capacity_factor=1.0,  # dropping dispatch at trillion scale
    source="arXiv:2501.kimi2 (assignment table; unverified)",
    notes="~1.03T total params, ~32B active; EP+FSDP mandatory",
)
