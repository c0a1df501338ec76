"""``ShardedKVBlockStore`` — N independent LSM shards behind one
``StorageBackend``.

The monolithic ``KVBlockStore`` funnels every request through a single
memtable, WAL, tensor log, and controller, which serializes all index and
log I/O; the paper's scalability claim (bounded file counts and metadata
overhead as the footprint grows) extends naturally to partitioned storage —
the move enterprise KV-cache layers make (LMCache-style partitioned,
independently-compacted shards behind one interface).

Routing: a stable 64-bit hash of the **first block's tokens** picks the
shard.  Every extension of a prefix shares its first block, so a whole
prefix tree lands on one shard — probes, range scans, and block contiguity
stay shard-local, and the prefix-closure property each shard's binary
search relies on is preserved.  Divergent corpora (different first blocks,
e.g. different tenants' system prompts) spread across shards.

Each shard is a full ``KVBlockStore`` (own memtable, WAL, tensor log,
merge service, and ``AdaptiveController``), so shards tune their LSM
shapes to *their* traffic independently and never contend on a shared
commit point.

Maintenance is round-robin: each cycle compacts ``shards_per_cycle``
shards, bounding per-cycle compaction work to O(1) shards regardless of N
(the paper's "scheduled compaction cycles", now amortized across the
fleet).  The byte budget is global: eviction drains the largest-footprint
shard first, so pressure lands proportional to shard footprint rather than
uniformly punishing cold shards.

Parallel fan-out: the multi-sequence operations (``probe_many`` /
``get_many`` / ``put_many``) group sequences by shard and run the shard
groups concurrently on an ``IOExecutor`` (``io_threads`` constructor
argument, or a shared executor via ``io_executor``).  Shards are fully
independent stores, so the groups contend on nothing — this is the step
that converts sharding from a locality win into a throughput win.  The
maintenance cycle fans its ``shards_per_cycle`` shard cycles out the same
way.  With no executor (``io_threads=0``) every path degrades to the
serial loop.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..runtime.executor import IOExecutor
from .backend import merge_stats
from .keycodec import TOKEN_WIDTH, encode_tokens
from .store import KVBlockStore, StoreStats

_META_FILE = "shards.json"


def shard_of_key(key: bytes, block_size: int, n_shards: int) -> int:
    """Stable shard index for an already-encoded index key: hash of the
    first block's worth of bytes.  Keys are the big-endian token encoding,
    so ``key[:TOKEN_WIDTH * block_size]`` is exactly the first block —
    migration imports route without decoding tokens."""
    head = bytes(key[: TOKEN_WIDTH * block_size])
    return int.from_bytes(hashlib.blake2b(head, digest_size=8).digest(), "little") % n_shards


def shard_of(tokens: Sequence[int], block_size: int, n_shards: int) -> int:
    """Stable shard index for a token sequence: hash of the first block.

    Uses blake2b (not ``hash()``) so routing survives process restarts —
    a shard must find its own data after recovery.
    """
    head = encode_tokens(tokens[: min(block_size, len(tokens))])
    return int.from_bytes(hashlib.blake2b(head, digest_size=8).digest(), "little") % n_shards


class ShardedKVBlockStore:
    """N-way sharded LSM KV-cache store satisfying ``StorageBackend``."""

    name = "lsm-sharded"

    def __init__(
        self,
        root: str,
        n_shards: int = 4,
        block_size: int = 16,
        budget_bytes: Optional[int] = None,
        shards_per_cycle: int = 2,
        io_threads: int = 0,
        io_executor: Optional[IOExecutor] = None,
        fsync_writes: bool = False,
        **shard_kwargs,
    ):
        """``shard_kwargs`` are forwarded to every ``KVBlockStore`` shard
        (codec, buffer_bytes, vlog_file_bytes, adaptive, ...).  The byte
        budget is enforced globally here, never per shard.

        ``io_threads`` > 0 creates an owned ``IOExecutor`` for parallel
        shard fan-out (closed with the store); alternatively pass a shared
        ``io_executor`` (not closed here).  ``fsync_writes`` is plumbed to
        every shard: each shard fsyncs its tensor log before the WAL-backed
        index insert commits (two-phase durability ordering)."""
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.root = root
        os.makedirs(root, exist_ok=True)
        meta_path = os.path.join(root, _META_FILE)
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            if meta["n_shards"] != n_shards or meta["block_size"] != block_size:
                raise ValueError(
                    f"store at {root} was created with n_shards={meta['n_shards']}, "
                    f"block_size={meta['block_size']}; reopened with n_shards={n_shards}, "
                    f"block_size={block_size} — routing (first-block hash) would orphan data"
                )
        else:
            with open(meta_path, "w") as f:
                json.dump({"n_shards": n_shards, "block_size": block_size}, f)
        self.n_shards = n_shards
        self.block_size = block_size
        self.budget_bytes = budget_bytes
        self.shards_per_cycle = max(1, min(shards_per_cycle, n_shards))
        # Each shard observes ~1/N of the op stream, so its adaptive
        # controller needs a proportionally smaller window (and tuning
        # cadence) to react on the same wall-clock horizon as a monolithic
        # store — otherwise shards never reach the drift threshold and stay
        # pinned to the default leveling policy, over-compacting under
        # write-heavy traffic.
        window = shard_kwargs.pop("controller_window", 4096)
        shard_kwargs["controller_window"] = max(256, window // n_shards)
        self.shards: List[KVBlockStore] = [
            KVBlockStore(
                os.path.join(root, f"shard_{i:03d}"),
                block_size=block_size,
                budget_bytes=None,
                fsync_writes=fsync_writes,
                **shard_kwargs,
            )
            for i in range(n_shards)
        ]
        self.fsync_writes = fsync_writes
        if io_executor is not None:
            self._executor, self._owns_executor = io_executor, False
        elif io_threads > 0:
            self._executor = IOExecutor(max_workers=io_threads)
            self._owns_executor = True
        else:
            self._executor, self._owns_executor = None, False
        for s in self.shards:
            s.controller.min_ops_between_tunings = max(
                64, s.controller.min_ops_between_tunings // n_shards
            )
        self._rr = 0  # round-robin maintenance cursor

    def set_io_executor(self, executor: Optional[IOExecutor], own: bool = False) -> None:
        """Swap the fan-out executor (e.g. to share the serving runtime's
        pool, or for benchmark sweeps over thread counts).  Closes the
        previous executor if this store owned it."""
        if self._owns_executor and self._executor is not None and self._executor is not executor:
            self._executor.close()
        self._executor = executor
        self._owns_executor = bool(own and executor is not None)

    # --------------------------------------------------------------- routing
    def shard_for(self, tokens: Sequence[int]) -> KVBlockStore:
        return self.shards[shard_of(tokens, self.block_size, self.n_shards)]

    # ---------------------------------------------------------------- contract
    def put_batch(
        self,
        tokens: Sequence[int],
        blocks: Sequence[np.ndarray],
        start_block: int = 0,
        skip_existing: bool = True,
    ) -> int:
        return self.shard_for(tokens).put_batch(
            tokens, blocks, start_block=start_block, skip_existing=skip_existing
        )

    def probe(self, tokens: Sequence[int]) -> int:
        return self.shard_for(tokens).probe(tokens)

    def get_batch(
        self, tokens: Sequence[int], n_tokens: int, start_block: int = 0
    ) -> List[np.ndarray]:
        return self.shard_for(tokens).get_batch(tokens, n_tokens, start_block=start_block)

    def get_batch_raw(self, tokens: Sequence[int], n_tokens: int):
        """Sendfile-able extent for the sequence, if its shard has one
        (a prefix tree lives entirely on one shard, so this is a pure
        delegation)."""
        return self.shard_for(tokens).get_batch_raw(tokens, n_tokens)

    def get_batch_encoded(self, tokens: Sequence[int], n_tokens: int):
        """Encoded (still-compressed) payloads for the cached prefix —
        shard-local like every other per-sequence op."""
        return self.shard_for(tokens).get_batch_encoded(tokens, n_tokens)

    # ------------------------------------------------------- parallel fan-out
    def _shard_groups(self, seqs: Sequence[Sequence[int]]) -> Dict[int, List[int]]:
        """Map shard index -> positions in ``seqs`` routed to it."""
        groups: Dict[int, List[int]] = {}
        for pos, tokens in enumerate(seqs):
            groups.setdefault(shard_of(tokens, self.block_size, self.n_shards), []).append(pos)
        return groups

    def _fan_out(self, seqs: Sequence[Sequence[int]], per_item) -> list:
        """Run ``per_item(shard, position)`` for every sequence, grouped by
        shard; groups run in parallel on the executor (serial without one).
        Large groups are split into chunks so a hot shard (hash skew) does
        not become the fan-out's makespan — shards are thread-safe, so
        same-shard chunks may run concurrently.  Results are positional:
        ``out[i]`` answers item ``i``."""
        groups = self._shard_groups(seqs)
        out: list = [None] * len(seqs)

        def run_chunk(arg: Tuple[int, List[int]]) -> None:
            si, positions = arg
            shard = self.shards[si]
            for pos in positions:
                out[pos] = per_item(shard, pos)

        if self._executor is not None and len(seqs) > 1:
            # chunk for load balance: ~4 tasks per worker across the batch
            workers = max(1, self._executor.max_workers)
            chunk = max(1, len(seqs) // (4 * workers))
            tasks = [
                (si, positions[i : i + chunk])
                for si, positions in groups.items()
                for i in range(0, len(positions), chunk)
            ]
            self._executor.map_parallel(run_chunk, tasks)
        else:
            for item in groups.items():
                run_chunk(item)
        return out

    def probe_many(self, seqs: Sequence[Sequence[int]]) -> List[int]:
        return self._fan_out(seqs, lambda shard, pos: shard.probe(seqs[pos]))

    def get_many(self, items: Sequence[Tuple[Sequence[int], int]]) -> List[List[np.ndarray]]:
        return self._fan_out(
            [t for t, _ in items],
            lambda shard, pos: shard.get_batch(items[pos][0], items[pos][1]),
        )

    def put_many(
        self, items: Sequence[Tuple[Sequence[int], Sequence[np.ndarray], int]]
    ) -> List[int]:
        return self._fan_out(
            [t for t, _, _ in items],
            lambda shard, pos: shard.put_batch(items[pos][0], items[pos][1], start_block=items[pos][2]),
        )

    # ----------------------------------------------- key export (elasticity)
    # The cursor prefixes the inner shard cursor with a u16 shard index, so
    # the page stream walks shard 0's keyspace, then shard 1's, ... — still
    # a stable total order, which is all ``cluster.migration`` needs.

    def scan_keys(self, cursor: Optional[bytes] = None, limit: int = 1024):
        if cursor is None:
            si, inner = 0, None
        else:
            (si,) = struct.unpack(">H", bytes(cursor[:2]))
            inner = bytes(cursor[2:]) or None
        while si < self.n_shards:
            keys, nxt = self.shards[si].scan_keys(inner, limit)
            if nxt is not None:
                return keys, struct.pack(">H", si) + nxt
            if si + 1 < self.n_shards:
                if keys:
                    return keys, struct.pack(">H", si + 1)
                si, inner = si + 1, None
                continue
            return keys, None
        return [], None

    def export_encoded(self, keys: Sequence[bytes]):
        out: list = [None] * len(keys)
        groups: Dict[int, List[int]] = {}
        for pos, key in enumerate(keys):
            groups.setdefault(shard_of_key(key, self.block_size, self.n_shards), []).append(pos)
        for si, positions in groups.items():
            recs = self.shards[si].export_encoded([keys[p] for p in positions])
            for p, rec in zip(positions, recs):
                out[p] = rec
        return out

    def import_encoded(self, records, skip_existing: bool = True) -> int:
        groups: Dict[int, list] = {}
        for rec in records:
            groups.setdefault(
                shard_of_key(rec[0], self.block_size, self.n_shards), []
            ).append(rec)
        return sum(
            self.shards[si].import_encoded(recs, skip_existing=skip_existing)
            for si, recs in groups.items()
        )

    def maintenance(self, compact_steps: int = 8) -> dict:
        """One cycle: compact/merge the next ``shards_per_cycle`` shards
        (round-robin), then enforce the global budget.  The report carries
        the same top-level keys as the monolithic store (``compactions``,
        ``evicted_files``) plus a per-shard breakdown, so callers account
        for maintenance uniformly across backends."""
        rep: dict = {"compactions": 0, "shards": {}}
        cycle: List[int] = []
        for _ in range(self.shards_per_cycle):
            cycle.append(self._rr % self.n_shards)
            self._rr += 1
        # shards are independent engines: their compaction/merge cycles fan
        # out in parallel (each shard's maintenance serializes internally)
        def one(i: int) -> dict:
            return self.shards[i].maintenance(compact_steps)

        if self._executor is not None and len(cycle) > 1:
            reports = self._executor.map_parallel(one, cycle)
        else:
            reports = [one(i) for i in cycle]
        for i, srep in zip(cycle, reports):
            rep["shards"][i] = srep
            rep["compactions"] += srep.get("compactions", 0)
            tiering = srep.get("tiering")
            if tiering:
                agg = rep.setdefault(
                    "tiering", {"files": 0, "demoted_blocks": 0,
                                "bytes_before": 0, "bytes_after": 0})
                for k in agg:
                    agg[k] += tiering.get(k, 0)
        if self.budget_bytes is not None:
            rep["evicted_files"] = self._evict_to_budget()
        return rep

    def _evict_to_budget(self) -> int:
        """Global FIFO eviction, heaviest shard first: repeatedly drop the
        oldest tensor-log file of the largest-footprint shard until the
        aggregate is under budget.  Footprint-proportional by construction —
        a shard holding k× the bytes absorbs ~k× the evictions."""
        evicted = 0
        while self.disk_bytes > self.budget_bytes:
            # heaviest shard first, but fall through to lighter shards when
            # the heaviest is down to its active file (it can't evict, yet
            # others may still hold sealed files)
            for s in sorted(self.shards, key=lambda s: s.disk_bytes, reverse=True):
                if s.evict_oldest_file():
                    evicted += 1
                    break
            else:
                break  # every shard is down to its active file
        return evicted

    # ------------------------------------------------------------ lifecycle
    def flush(self) -> None:
        for s in self.shards:
            s.flush()

    def sync_wal(self) -> None:
        for s in self.shards:
            s.sync_wal()

    def close(self) -> None:
        if self._owns_executor and self._executor is not None:
            self._executor.close()
        for s in self.shards:
            s.close()

    # ----------------------------------------------------------------- stats
    @property
    def stats(self) -> StoreStats:
        return merge_stats(s.stats for s in self.shards)

    @property
    def disk_bytes(self) -> int:
        return sum(s.disk_bytes for s in self.shards)

    @property
    def file_count(self) -> int:
        return sum(s.file_count for s in self.shards)

    def shard_disk_bytes(self) -> List[int]:
        return [s.disk_bytes for s in self.shards]

    def shard_file_counts(self) -> List[int]:
        return [s.file_count for s in self.shards]

    def per_shard_stats(self) -> Dict[int, StoreStats]:
        return {i: s.stats for i, s in enumerate(self.shards)}

    @property
    def write_amplification(self) -> float:
        """Aggregate LSM write amplification across shard indexes."""
        cin = sum(s.index.stats.compact_bytes_in for s in self.shards)
        cout = sum(s.index.stats.compact_bytes_out for s in self.shards)
        return cout / max(1, cin)
