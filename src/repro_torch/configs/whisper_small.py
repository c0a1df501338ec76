"""Whisper-small — encoder-decoder ASR backbone; conv frontend is a stub
(input_specs provides precomputed frame embeddings) [arXiv:2212.04356]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,  # decoder layers
    n_enc_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    enc_frames=1500,
    causal=True,
    source="arXiv:2212.04356",
    notes="modality frontend stubbed per assignment; decoder prefix reuse only",
)
