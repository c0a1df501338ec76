"""Architecture registry: the 10 assigned architectures + paper-eval models.

Each module defines CONFIG (exact published dims) and the registry maps
``--arch <id>`` to it.  ``get_config(id, smoke=True)`` returns the reduced
same-family variant used by CPU smoke tests.
"""

from __future__ import annotations

from .base import LONG_CONTEXT_OK, SHAPES, ModelConfig, ShapeConfig, smoke_variant

from . import (  # noqa: E402
    chameleon_34b,
    glm4_9b,
    kimi_k2_1t_a32b,
    minicpm3_4b,
    olmoe_1b_7b,
    qwen25_32b,
    qwen3_14b,
    rwkv6_1b6,
    whisper_small,
    zamba2_1b2,
)

REGISTRY = {
    "olmoe-1b-7b": olmoe_1b_7b.CONFIG,
    "kimi-k2-1t-a32b": kimi_k2_1t_a32b.CONFIG,
    "rwkv6-1.6b": rwkv6_1b6.CONFIG,
    "whisper-small": whisper_small.CONFIG,
    "minicpm3-4b": minicpm3_4b.CONFIG,
    "qwen2.5-32b": qwen25_32b.CONFIG,
    "qwen3-14b": qwen3_14b.CONFIG,
    "glm4-9b": glm4_9b.CONFIG,
    "chameleon-34b": chameleon_34b.CONFIG,
    "zamba2-1.2b": zamba2_1b2.CONFIG,
}

ARCH_IDS = list(REGISTRY)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    cfg = REGISTRY[arch]
    return smoke_variant(cfg) if smoke else cfg


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells with skip annotations (DESIGN.md §4)."""
    out = []
    for arch in ARCH_IDS:
        for shape in SHAPES.values():
            skip = None
            if shape.name == "long_500k" and arch not in LONG_CONTEXT_OK:
                skip = "full-attention arch: 500k dense decode out of scope (DESIGN.md §4)"
            if skip is None or include_skipped:
                out.append((arch, shape.name, skip))
    return out


__all__ = [
    "REGISTRY",
    "ARCH_IDS",
    "SHAPES",
    "LONG_CONTEXT_OK",
    "ModelConfig",
    "ShapeConfig",
    "get_config",
    "smoke_variant",
    "cells",
]
