"""Chameleon-34B — early-fusion VLM backbone; VQ image tokens share the text
vocabulary, so the frontend stub is the token stream itself
[arXiv:2405.09818]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="dense",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,  # chameleon stabilizes early fusion with qk-norm
    source="arXiv:2405.09818",
    notes="early fusion = unified token space; image tokenizer stubbed",
)
