"""``StorageBackend`` — the storage contract of the reproduction.

Every disk/memory backend (``KVBlockStore``, ``ShardedKVBlockStore``,
``FilePerObjectStore``, ``MemoryOnlyStore``) satisfies this protocol, and
the layers above storage — ``cache.hierarchy.CacheHierarchy``,
``serving.engine.ServingEngine``, the workload drivers and benchmarks —
depend only on it.  Swapping the engine's disk tier is a constructor
argument, never a code change.

The contract (paper §3.2, Fig. 6):

    put_batch(tokens, blocks, start_block, skip_existing) -> n_written
    probe(tokens) -> n_tokens        longest *contiguous* cached prefix
    get_batch(tokens, n_tokens)      blocks covering tokens[:n_tokens]
    probe_many / get_many / put_many multi-sequence forms (a sharded
                                     backend fans these out in parallel)
    maintenance(compact_steps)       one scheduled maintenance cycle
    flush() / close()                durability / lifecycle
    stats / disk_bytes / file_count  observability

Optional fast-path methods (duck-typed; the cluster server probes with
``getattr`` and falls back to ``get_batch``):

    get_batch_raw(tokens, n)      the prefix as one contiguous tensor-log
                                  extent (``RawBatch``) for ``os.sendfile``
    get_batch_encoded(tokens, n)  the prefix as still-encoded codec
                                  payloads (bytes), so compressed tiers
                                  ship compressed over the wire

Optional elasticity methods (duck-typed the same way; ``cluster.migration``
uses them to move blocks between nodes during membership changes):

    scan_keys(cursor, limit)      one page of live index keys in a stable
                                  total order -> (keys, next_cursor)
    export_encoded(keys)          stored records as (tier_flags, payload)
                                  pairs, still encoded (None if absent)
    import_encoded(records,       accept foreign (key, flags, payload)
                    skip_existing) records verbatim; idempotent when
                                  skip_existing — returns #blocks written

The LSM backends also accept a ``tiering=TieringPolicy`` constructor
argument (``core.tiering``): puts then write the raw hot tier and the
maintenance cycle demotes idle blocks to int8 / int8+zlib off-path.

Invariants every backend must keep:
  * ``probe`` never promises tokens ``get_batch`` would truncate — it
    reports a contiguous, immediately readable prefix;
  * ``put_batch`` keys block ``i`` by the whole token prefix through block
    ``i`` (content addressing), so identical prefixes dedup across requests;
  * ``maintenance`` is deterministic and caller-scheduled — no backend
    spawns its own threads.  The ``repro.runtime`` layer supplies threads
    (``MaintenanceService`` and the I/O executor) when the deployment
    wants work off the request path.

Thread-safety contract (the concurrent runtime layer depends on this):
  * Every method above is safe to call from multiple threads concurrently,
    including ``maintenance`` racing reads and writes.  Implementations
    use internal fine-grained locks: the LSM index and tensor-log
    *bookkeeping* are lock-protected, while bulk payload reads from
    immutable log files / SSTs take no lock at all (readers re-resolve
    pointers and retry if eviction or a merge removed a file mid-read).
  * Writes are never lost and reads are never torn: a reader sees either
    a block's committed bytes (CRC-verified in the tensor log) or no block
    — never a partial or mixed record.
  * ``stats`` counters are updated under a lock so they sum correctly
    across threads (``merge_stats`` relies on additivity).
  * ``close`` is not required to be safe against in-flight operations;
    callers quiesce (drain executors/queues) first.
"""

from __future__ import annotations

from dataclasses import fields
from typing import Iterable, List, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np

from .batchops import BatchOpsMixin
from .store import StoreStats

__all__ = ["StorageBackend", "BatchOpsMixin", "merge_stats"]


@runtime_checkable
class StorageBackend(Protocol):
    """Structural protocol for KV-cache storage backends.

    ``runtime_checkable`` supports ``isinstance`` conformance checks in
    tests; static checkers verify the full signatures.
    """

    name: str
    block_size: int

    def put_batch(
        self,
        tokens: Sequence[int],
        blocks: Sequence[np.ndarray],
        start_block: int = 0,
        skip_existing: bool = True,
    ) -> int: ...

    def probe(self, tokens: Sequence[int]) -> int: ...

    def get_batch(self, tokens: Sequence[int], n_tokens: int) -> List[np.ndarray]: ...

    def probe_many(self, seqs: Sequence[Sequence[int]]) -> List[int]: ...

    def get_many(
        self, items: Sequence[Tuple[Sequence[int], int]]
    ) -> List[List[np.ndarray]]: ...

    def put_many(
        self, items: Sequence[Tuple[Sequence[int], Sequence[np.ndarray], int]]
    ) -> List[int]: ...

    def maintenance(self, compact_steps: int = 8) -> dict: ...

    def flush(self) -> None: ...

    def close(self) -> None: ...

    @property
    def stats(self) -> StoreStats: ...

    @property
    def disk_bytes(self) -> int: ...

    @property
    def file_count(self) -> int: ...


def merge_stats(parts: Iterable[StoreStats]) -> StoreStats:
    """Aggregate per-shard ``StoreStats`` into one view (all fields are
    additive counters/timers)."""
    out = StoreStats()
    for s in parts:
        for f in fields(StoreStats):
            setattr(out, f.name, getattr(out, f.name) + getattr(s, f.name))
    return out
