"""Serial reference implementations of the multi-sequence batch ops
(``probe_many`` / ``get_many`` / ``put_many``).

Lives in its own module so both ``backend`` (the protocol) and the
concrete stores can import it without a cycle.  ``ShardedKVBlockStore``
overrides these with parallel shard fan-out on an ``IOExecutor``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


class BatchOpsMixin:
    """Loop-based multi-sequence ops; ``out[i]`` answers ``items[i]``."""

    def probe_many(self, seqs: Sequence[Sequence[int]]) -> List[int]:
        return [self.probe(t) for t in seqs]

    def get_many(self, items: Sequence[Tuple[Sequence[int], int]]) -> List[List[np.ndarray]]:
        return [self.get_batch(t, n) for t, n in items]

    def put_many(
        self, items: Sequence[Tuple[Sequence[int], Sequence[np.ndarray], int]]
    ) -> List[int]:
        return [self.put_batch(t, blocks, start_block=s) for t, blocks, s in items]
