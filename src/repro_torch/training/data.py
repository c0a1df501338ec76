"""Deterministic, checkpointable data pipeline.

Batches are a pure function of (seed, step): resuming from a checkpoint at
step k replays exactly the batches k, k+1, ... with no iterator state to
persist beyond the step counter — the property the auto-resume train loop
and the elastic-restore tests rely on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticLM:
    """Seeded synthetic LM stream: shifted-token prediction over structured
    random sequences (mixture of repeated motifs so the loss is learnable)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # motifs are fixed per seed (not per step) so the stream is learnable
        self._motifs = np.random.default_rng(cfg.seed).integers(
            0, cfg.vocab_size, size=(8, 32)
        )

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng((c.seed << 20) ^ step)
        motifs = self._motifs
        rows = []
        for _ in range(c.global_batch):
            parts = []
            while sum(len(p) for p in parts) < c.seq_len + 1:
                if rng.random() < 0.7:
                    parts.append(motifs[rng.integers(0, len(motifs))])
                else:
                    parts.append(rng.integers(0, c.vocab_size, size=16))
            row = np.concatenate(parts)[: c.seq_len + 1]
            rows.append(row)
        arr = np.stack(rows).astype(np.int32)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
