"""GLM-4-9B — dense, aggressive GQA (2 KV heads), RoPE [hf:THUDM/glm-4-9b]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    source="hf:THUDM/glm-4-9b",
    notes="smallest KV/token of the dense set -> paper Fig.5 sweet spot",
)
