"""Baseline disk/memory KV-cache stores the paper evaluates against (§4.1):

* ``FilePerObjectStore`` — SGLang(file): one file per KV block, named by a
  hash of the token prefix.  Exhibits exactly the §1 pathologies: per-file
  open/write/close syscalls, no batching, filesystem block rounding (a
  2 KiB payload consumes >=4 KiB + inode), metadata pressure as file counts
  grow.  Filesystem overhead is charged for real via ``st_blocks``-style
  rounding so both backends compete under the same *physical* byte budget.

* ``MemoryOnlyStore`` — SGLang(memory): LRU dict bounded by a byte budget
  (models HBM+DRAM capacity, which forces the evictions the paper
  describes).

Both satisfy the ``repro.core.backend.StorageBackend`` protocol — including
its probe invariant (a probe reports a *contiguous* readable prefix, even
after LRU eviction punches holes mid-prefix) — so the hierarchy, serving
engine, and benchmarks are backend-agnostic.

Thread-safety: baselines take one coarse re-entrant lock around every
public operation.  That satisfies the backend contract (no lost writes, no
torn reads, consistent stats) without complicating code whose entire role
is to be the simple comparison point; the fine-grained design that keeps
readers lock-free lives in ``KVBlockStore``.
"""

from __future__ import annotations

import functools
import hashlib
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from .batchops import BatchOpsMixin
from .codec import CODEC_RAW, BatchCodec
from .keycodec import encode_tokens
from .store import StoreStats


def _locked(fn):
    """Run the method under the instance's coarse ``_lock``."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)

    return wrapper

FS_BLOCK = 4096  # filesystem allocation unit
INODE_OVERHEAD = 256  # metadata bytes charged per file (inode + dirent)


def fs_footprint(payload_bytes: int) -> int:
    """Physical bytes a payload costs in a file-per-object layout."""
    blocks = (payload_bytes + FS_BLOCK - 1) // FS_BLOCK
    return max(1, blocks) * FS_BLOCK + INODE_OVERHEAD


class FilePerObjectStore(BatchOpsMixin):
    """One file per KV block (state-of-practice disk backend)."""

    name = "file"

    def __init__(
        self,
        root: str,
        block_size: int = 16,
        codec: Optional[BatchCodec] = None,
        budget_bytes: Optional[int] = None,
        max_files: Optional[int] = None,
        meta_penalty_per_file_s: float = 0.0,
    ):
        """``meta_penalty_per_file_s``: optional modeled metadata latency per
        file operation per million resident files (calibrated by
        ``benchmarks/store_scalability.py`` from real measurements; default
        off so everything measured is real I/O)."""
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.block_size = block_size
        # the file backend cannot batch-compress (paper §3.4), so default raw
        self.codec = codec or BatchCodec(CODEC_RAW, use_zlib=False)
        self.budget_bytes = budget_bytes
        self.max_files = max_files
        self.meta_penalty = meta_penalty_per_file_s
        self._lru: "OrderedDict[str, int]" = OrderedDict()  # path -> fs bytes
        self.fs_bytes = 0
        self.stats = StoreStats()
        self.modeled_penalty_s = 0.0
        # holes mid-prefix only appear after an eviction or a refused write
        # (max_files wall); until then probe stays O(log n).  Persisted via
        # a marker file (as in KVBlockStore) so the probe contiguity
        # invariant survives reopen.
        self._holes_marker = os.path.join(root, "evicted.marker")
        self._may_have_holes = os.path.exists(self._holes_marker)
        self._lock = threading.RLock()
        self._recover()

    def _mark_holes(self) -> None:
        if not self._may_have_holes:
            self._may_have_holes = True
            open(self._holes_marker, "w").close()

    def _recover(self) -> None:
        for dirpath, _, files in os.walk(self.root):
            for f in files:
                if not f.endswith(".bin"):
                    continue  # bookkeeping files (evicted.marker) are not objects
                p = os.path.join(dirpath, f)
                fp = fs_footprint(os.path.getsize(p))
                self._lru[p] = fp
                self.fs_bytes += fp

    def _path(self, tokens: Sequence[int], n_tokens: int) -> str:
        h = hashlib.sha1(encode_tokens(tokens[:n_tokens])).hexdigest()
        return os.path.join(self.root, h[:2], h[2:4], h + ".bin")

    def _charge_meta(self) -> None:
        if self.meta_penalty:
            self.modeled_penalty_s += self.meta_penalty * (len(self._lru) / 1e6)

    def _touch(self, path: str) -> None:
        if path in self._lru:
            self._lru.move_to_end(path)

    @_locked
    def put_batch(self, tokens, blocks, start_block: int = 0, skip_existing: bool = True) -> int:
        B = self.block_size
        t0 = time.perf_counter()
        wrote = 0
        for i, block in enumerate(blocks):
            end = (start_block + i + 1) * B
            if end > len(tokens):
                break
            path = self._path(tokens, end)
            self._charge_meta()
            if skip_existing and path in self._lru:
                self._touch(path)
                continue
            if self.max_files is not None and len(self._lru) >= self.max_files:
                # the §4.2 wall: filesystem refuses/degrades past the file cap
                self._mark_holes()  # a later block may still land
                continue
            payload = self.codec.encode(np.asarray(block))
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "wb") as f:  # one open/write/close per object
                f.write(payload)
            fp = fs_footprint(len(payload))
            self._lru[path] = fp
            self.fs_bytes += fp
            self.stats.payload_bytes_in += np.asarray(block).nbytes
            self.stats.payload_bytes_stored += len(payload)
            wrote += 1
        self.stats.put_blocks += wrote
        self.stats.put_tokens += wrote * B
        self.stats.io_write_s += time.perf_counter() - t0
        if self.budget_bytes is not None:
            self._evict_to_budget()
        return wrote

    @_locked
    def probe(self, tokens) -> int:
        B = self.block_size
        max_blocks = len(tokens) // B
        self.stats.probes += 1
        lo, hi = 0, max_blocks
        while lo < hi:
            mid = (lo + hi + 1) // 2
            self._charge_meta()
            self.stats.probe_lookups += 1
            if os.path.exists(self._path(tokens, mid * B)):  # stat() syscall
                lo = mid
            else:
                hi = mid - 1
        # LRU eviction (budget) and refused writes (max_files wall) punch
        # holes mid-prefix; confirm contiguity so probe matches what
        # get_batch can actually return.  Until a hole can exist, probe
        # keeps the pure O(log n) binary search.
        if lo and self._may_have_holes:
            k = 0
            while k < lo:
                self._charge_meta()
                self.stats.probe_lookups += 1
                if not os.path.exists(self._path(tokens, (k + 1) * B)):
                    break
                k += 1
            lo = k
        if lo == 0:
            self.stats.probe_empty += 1
        else:
            self.stats.probe_hits += 1
        return lo * B

    @_locked
    def get_batch(self, tokens, n_tokens: int) -> List[np.ndarray]:
        B = self.block_size
        t0 = time.perf_counter()
        out: List[np.ndarray] = []
        for i in range(n_tokens // B):
            path = self._path(tokens, (i + 1) * B)
            self._charge_meta()
            if not os.path.exists(path):
                break
            with open(path, "rb") as f:  # open/read/close per object
                out.append(BatchCodec.decode(f.read()))
            self._touch(path)
        self.stats.get_blocks += len(out)
        self.stats.get_tokens += len(out) * B
        self.stats.io_read_s += time.perf_counter() - t0
        return out

    def _evict_to_budget(self) -> None:
        while self.fs_bytes > self.budget_bytes and self._lru:
            self._mark_holes()
            path, fp = self._lru.popitem(last=False)
            try:
                os.remove(path)
            except OSError:
                pass
            self.fs_bytes -= fp
            self.stats.evicted_blocks += 1

    @_locked
    def maintenance(self, compact_steps: int = 0) -> dict:
        if self.budget_bytes is not None:
            self._evict_to_budget()
        return {}

    @property
    def disk_bytes(self) -> int:
        return self.fs_bytes

    @property
    def file_count(self) -> int:
        return len(self._lru)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class MemoryOnlyStore(BatchOpsMixin):
    """In-memory LRU KV cache bounded by a byte budget."""

    name = "memory"

    def __init__(self, budget_bytes: int, block_size: int = 16, **_):
        self.block_size = block_size
        self.budget_bytes = budget_bytes
        self._lru: "OrderedDict[bytes, np.ndarray]" = OrderedDict()
        self.bytes = 0
        self.stats = StoreStats()
        self._may_have_holes = False  # set on first LRU eviction
        self._lock = threading.RLock()

    def _key(self, tokens, n_tokens: int) -> bytes:
        return encode_tokens(tokens[:n_tokens])

    @_locked
    def put_batch(self, tokens, blocks, start_block: int = 0, skip_existing: bool = True) -> int:
        B = self.block_size
        wrote = 0
        for i, block in enumerate(blocks):
            end = (start_block + i + 1) * B
            if end > len(tokens):
                break
            key = self._key(tokens, end)
            if skip_existing and key in self._lru:
                self._lru.move_to_end(key)
                continue
            arr = np.asarray(block)
            self._lru[key] = arr
            self.bytes += arr.nbytes
            self.stats.payload_bytes_in += arr.nbytes
            self.stats.payload_bytes_stored += arr.nbytes
            wrote += 1
        while self.bytes > self.budget_bytes and self._lru:
            self._may_have_holes = True
            _, old = self._lru.popitem(last=False)
            self.bytes -= old.nbytes
            self.stats.evicted_blocks += 1
        self.stats.put_blocks += wrote
        self.stats.put_tokens += wrote * B
        return wrote

    @_locked
    def probe(self, tokens) -> int:
        B = self.block_size
        self.stats.probes += 1
        lo, hi = 0, len(tokens) // B
        while lo < hi:
            mid = (lo + hi + 1) // 2
            self.stats.probe_lookups += 1
            if self._key(tokens, mid * B) in self._lru:
                lo = mid
            else:
                hi = mid - 1
        # confirm contiguity once LRU eviction can have punched holes
        # (protocol invariant: probe never promises what get_batch lacks)
        if lo and self._may_have_holes:
            k = 0
            while k < lo and self._key(tokens, (k + 1) * B) in self._lru:
                k += 1
            lo = k
        if lo == 0:
            self.stats.probe_empty += 1
        else:
            self.stats.probe_hits += 1
        return lo * B

    @_locked
    def get_batch(self, tokens, n_tokens: int) -> List[np.ndarray]:
        B = self.block_size
        out: List[np.ndarray] = []
        for i in range(n_tokens // B):
            key = self._key(tokens, (i + 1) * B)
            blk = self._lru.get(key)
            if blk is None:
                break
            self._lru.move_to_end(key)
            out.append(blk)
        self.stats.get_blocks += len(out)
        self.stats.get_tokens += len(out) * B
        return out

    # ----------------------------------------------- key export (elasticity)
    # The cluster migration trio (see core.store).  Memory blocks are held
    # decoded, so export wraps them in the raw codec (flags 0 = hot tier)
    # and import decodes — the self-describing codec header keeps this
    # interoperable with LSM nodes that ship compressed tiers.

    @_locked
    def scan_keys(self, cursor: Optional[bytes] = None, limit: int = 1024):
        keys = sorted(k for k in self._lru if cursor is None or k > cursor)
        page = keys[:limit]
        next_cursor = page[-1] if len(keys) > limit else None
        return page, next_cursor

    @_locked
    def export_encoded(self, keys: Sequence[bytes]):
        codec = BatchCodec(CODEC_RAW, use_zlib=False)
        out = []
        n = 0
        for k in keys:
            blk = self._lru.get(bytes(k))
            if blk is None:
                out.append(None)
            else:
                out.append((0, codec.encode(blk)))
                n += 1
        self.stats.exported_blocks += n
        return out

    @_locked
    def import_encoded(self, records, skip_existing: bool = True) -> int:
        wrote = 0
        for key, _flags, payload in records:
            key = bytes(key)
            if skip_existing and key in self._lru:
                continue
            arr = BatchCodec.decode(bytes(payload))
            self._lru[key] = arr
            self.bytes += arr.nbytes
            self.stats.imported_blocks += 1
            self.stats.imported_bytes += len(payload)
            self.stats.payload_bytes_stored += arr.nbytes
            wrote += 1
        if wrote:
            # imported arcs need not be prefix-closed: verify contiguity
            self._may_have_holes = True
        while self.bytes > self.budget_bytes and self._lru:
            self._may_have_holes = True
            _, old = self._lru.popitem(last=False)
            self.bytes -= old.nbytes
            self.stats.evicted_blocks += 1
        return wrote

    @_locked
    def maintenance(self, compact_steps: int = 0) -> dict:
        return {}

    @property
    def disk_bytes(self) -> int:
        return self.bytes

    @property
    def file_count(self) -> int:
        return len(self._lru)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass
