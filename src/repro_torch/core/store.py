"""``KVBlockStore`` — the public contract of SGLANG-LSM (paper §3.2, Fig. 6):

    put_batch(tokens, blocks)   store sequential KV-cache blocks
    probe(tokens) -> n_tokens   longest cached prefix (binary search +
                                Bloom-pruned LSM point lookups)
    get_batch(tokens, n)        one LSM range scan + coalesced tensor-log
                                batch read + batch decode

Two-phase write protocol: tensor payloads are committed to the tensor log
first; the atomic commit point is the WAL-backed index insert (a crash in
between leaves unreferenced log records, which the merge service garbage
collects).

Index entry value layout: ``LogPointer(20B) | u8 flags`` — compact metadata
only, per key-value separation.

Concurrency (see ``backend.py`` for the cross-backend contract): mutators
(``put_batch``, ``maintenance``, eviction, flush) serialize on a store
mutation lock; ``probe``/``get_batch`` run concurrently with them — index
point/range lookups are protected inside ``LSMTree``, tensor-log payload
reads are lock-free against immutable log files, and a read that loses a
race with file eviction/merging re-resolves its pointers from the index
and retries.  Stats and the adaptive controller share a dedicated lock so
counters sum correctly under concurrent load.

Parallel decode: ``get_batch`` splits its records into contiguous
chunks, at most one a block and one a decoder, decodes the first on the
calling thread and the rest on one decode pool shared by every store in
the process (not the ``IOExecutor`` the fetches themselves run on, so a
fetch never waits on a slot its own siblings hold).  The codec's zlib
inflate and numpy casts release the GIL on block-sized buffers, so the
chunks run on separate cores.  A one-block get, or any get on a one-CPU
host, is one chunk and never leaves the caller.

Durability ordering (two-phase write): with ``fsync_writes`` enabled the
tensor-log append is fsynced **before** the WAL-backed index insert, so a
crash can only ever leave *unreferenced* log records (garbage the merge
service collects) — never an index entry pointing at bytes that were lost.
"""

from __future__ import annotations

import os
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..obs.tracing import maybe_span
from .batchops import BatchOpsMixin
from .codec import CODEC_INT8, BatchCodec
from .controller import OP_EMPTY, OP_RANGE, OP_READ, OP_WRITE, AdaptiveController
from .keycodec import encode_tokens
from .lsm import LSMTree
from .merge import TensorFileMerger
from .tensorlog import PTR_BYTES, LogPointer, TensorLog
from .tiering import (
    TIER_HOT,
    TIER_MASK,
    TIER_NAMES,
    TierRecoder,
    TieringPolicy,
    tier_of_codec,
)

ENTRY_BYTES = PTR_BYTES + 1

# Decoders of one get's blocks, the calling thread included, at most, and
# never more than the CPUs the process may run on: past the host's cores
# more threads only convoy (see ``IOExecutor``).
DECODE_MAX_WORKERS = 8

_decode_lock = threading.Lock()
_decode_pool: Optional[ThreadPoolExecutor] = None
_decode_width = 1


def _usable_cpus() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # no affinity call on this platform
        return os.cpu_count() or 1


def _shared_decode_pool() -> Tuple[Optional[ThreadPoolExecutor], int]:
    """The process's decode pool, made on first use, and the decoders a
    get may use with it (its workers and the caller); ``(None, 1)`` on a
    one-core host."""
    global _decode_pool, _decode_width
    with _decode_lock:
        if _decode_pool is None:
            _decode_width = max(1, min(DECODE_MAX_WORKERS, _usable_cpus()))
            if _decode_width > 1:
                _decode_pool = ThreadPoolExecutor(
                    max_workers=_decode_width - 1, thread_name_prefix="repro-decode"
                )
        return _decode_pool, _decode_width


def _drop_decode_pool() -> None:
    """After ``fork`` the child has none of the parent's pool threads: it
    makes its own pool at its first get."""
    global _decode_lock, _decode_pool, _decode_width
    _decode_lock = threading.Lock()
    _decode_pool, _decode_width = None, 1


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_drop_decode_pool)


def _decode_all(payloads: Sequence) -> List[np.ndarray]:
    return [BatchCodec.decode(p) for p in payloads]


def _decode_records(payloads: Sequence) -> Tuple[List[np.ndarray], int]:
    """Decode ``payloads`` (bytes or views into one coalesced read) and
    return the arrays in order, with the count the pool's threads decoded.
    Contiguous chunks, at most one a block and one a decoder: the caller decodes the
    first, the pool the rest, and the caller then waits for the pool's
    chunks in order, so an error is the one a serial loop would raise first
    (the lowest-index bad payload's).  Returns only once every chunk has
    ended, so no pool thread still reads ``payloads`` after it."""
    n = len(payloads)
    pool, width = _shared_decode_pool()
    chunks = min(width, n)
    cut = [n * i // chunks for i in range(chunks + 1)]
    futs = []
    try:
        for i in range(1, chunks):
            futs.append(pool.submit(_decode_all, payloads[cut[i]:cut[i + 1]]))
    except RuntimeError:  # the interpreter is exiting: the pool takes no work
        wait(futs)
        return _decode_all(payloads), 0
    try:
        out = _decode_all(payloads[: cut[1]])
        for f in futs:
            out.extend(f.result())
    finally:
        wait(futs)
    return out, n - cut[1]


@dataclass
class StoreStats:
    put_blocks: int = 0
    put_tokens: int = 0
    get_blocks: int = 0
    get_tokens: int = 0
    probes: int = 0
    probe_hits: int = 0
    probe_empty: int = 0
    probe_lookups: int = 0
    payload_bytes_in: int = 0
    payload_bytes_stored: int = 0
    evicted_blocks: int = 0
    io_read_s: float = 0.0
    io_write_s: float = 0.0
    raw_gets: int = 0  # get_batch_raw calls that found a sendfile-able extent
    raw_get_blocks: int = 0
    # compression-tier accounting (see core.tiering).  The tier counts are
    # resident blocks per tier — kept exact under put/demote/evict, drift
    # only on overwrites (skip_existing=False superseding an indexed key).
    tier_hot_blocks: int = 0
    tier_warm_blocks: int = 0
    tier_cold_blocks: int = 0
    demoted_blocks: int = 0  # blocks re-encoded down-tier by maintenance
    demote_bytes_before: int = 0  # payload bytes of demoted blocks, pre/post
    demote_bytes_after: int = 0
    demote_s: float = 0.0  # off-path wall time spent transcoding
    # elasticity accounting: blocks shipped out of / into this store in
    # stored encoding (cluster migration + replica repair traffic)
    exported_blocks: int = 0
    imported_blocks: int = 0
    imported_bytes: int = 0  # stored payload bytes accepted by import
    # blocks of get_batch decoded on the shared decode pool's threads rather
    # than the caller's (see ``_decode_records``); over get_blocks, how often
    # a get's decode runs in parallel
    pooled_decode_blocks: int = 0

    @property
    def compression_ratio(self) -> float:
        return self.payload_bytes_in / max(1, self.payload_bytes_stored)

    @property
    def demote_bytes_saved(self) -> int:
        return self.demote_bytes_before - self.demote_bytes_after


@dataclass
class RawBatch:
    """A contiguous run of encoded blocks, as an *open file* plus an
    extent — the zero-copy handoff behind the cluster server's
    ``os.sendfile`` path.  The open handle pins the inode, so the bytes
    stay readable even if eviction unlinks the file mid-send.  The
    records are the on-disk ``crc | klen | plen | key | payload`` format;
    ``record_lengths[i]`` is the full length of block ``i``'s record, in
    ascending block order.  The caller owns ``file`` and must close it."""

    file: object
    offset: int
    length: int
    record_lengths: List[int]

    @property
    def n_blocks(self) -> int:
        return len(self.record_lengths)

    def close(self) -> None:
        try:
            self.file.close()
        except OSError:
            pass


class KVBlockStore(BatchOpsMixin):
    """Disk-resident KV-cache store over an LSM index + tensor log."""

    name = "lsm"

    def __init__(
        self,
        root: str,
        block_size: int = 16,
        codec: Optional[BatchCodec] = None,
        buffer_bytes: int = 1 << 20,
        size_ratio: int = 4,
        runs_per_level: int = 1,
        bloom_bits_per_key: float = 10.0,
        vlog_file_bytes: int = 32 * 1024 * 1024,
        max_log_files: int = 64,
        garbage_threshold: float = 0.5,
        budget_bytes: Optional[int] = None,
        adaptive: bool = True,
        controller_window: int = 4096,
        fsync: bool = False,
        fsync_writes: Optional[bool] = None,
        tiering: Optional[TieringPolicy] = None,
    ):
        # ``fsync_writes`` is the documented knob; ``fsync`` is kept as a
        # backward-compatible alias (either turns durability on).
        self.fsync_writes = bool(fsync) if fsync_writes is None else bool(fsync_writes)
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.block_size = block_size
        # With an adaptive tiering policy the put path always writes the
        # hot tier's codec (raw — zero codec CPU on the hot path); the
        # policy demotes blocks to int8 / int8+zlib off-path during
        # maintenance.  Without a policy the static ``codec`` applies and
        # every block is tagged with that codec's equivalent tier so the
        # per-tier gauges stay meaningful.
        self.tiering = tiering
        if tiering is not None:
            self.codec = tiering.codec_for(TIER_HOT)
            self._put_tier = TIER_HOT
        else:
            self.codec = codec or BatchCodec(CODEC_INT8, use_zlib=True)
            self._put_tier = tier_of_codec(self.codec)
        self.budget_bytes = budget_bytes
        self._lock = threading.RLock()  # serializes mutators (put/maintenance/evict)
        self._stats_lock = threading.Lock()  # stats counters + adaptive controller
        self.index = LSMTree(
            os.path.join(root, "index"),
            buffer_bytes=buffer_bytes,
            size_ratio=size_ratio,
            runs_per_level=runs_per_level,
            bloom_bits_per_key=bloom_bits_per_key,
            fsync=self.fsync_writes,
        )
        self.log = TensorLog(
            os.path.join(root, "log"),
            max_file_bytes=vlog_file_bytes,
            fsync_writes=self.fsync_writes,
        )
        self.merger = TensorFileMerger(
            self.log, self.index, max_files=max_log_files, garbage_threshold=garbage_threshold
        )
        self.controller = AdaptiveController(
            self.index, window=controller_window, entry_bytes=ENTRY_BYTES, enabled=adaptive
        )
        self.recoder = (
            TierRecoder(self.log, self.index, tiering,
                        entry_codec=(self._unpack_entry, self._pack_value))
            if tiering is not None else None
        )
        self.stats = StoreStats()
        # File eviction is the only operation that breaks prefix-closure
        # (holes mid-prefix); the marker persists that fact across reopens
        # so probe only pays contiguity verification on stores where holes
        # can actually exist.
        self._holes_marker = os.path.join(root, "evicted.marker")
        self._may_have_holes = os.path.exists(self._holes_marker)

    # ------------------------------------------------------------------ keys
    def _key(self, tokens: Sequence[int], n_tokens: int) -> bytes:
        return encode_tokens(tokens[:n_tokens])

    @staticmethod
    def _pack_value(ptr: LogPointer, flags: int = 0) -> bytes:
        return ptr.pack() + struct.pack("<B", flags)

    @staticmethod
    def _unpack_value(v: bytes) -> LogPointer:
        return LogPointer.unpack(v)

    @staticmethod
    def _unpack_entry(v: bytes):
        """Full entry: ``(LogPointer, flags)`` — bits 0-1 of flags are the
        compression tier (``core.tiering``)."""
        return LogPointer.unpack(v), (v[PTR_BYTES] if len(v) > PTR_BYTES else 0)

    def _bump_tier(self, tier: int, n: int) -> None:
        """Adjust one resident-per-tier gauge; caller holds ``_stats_lock``."""
        name = f"tier_{TIER_NAMES[tier]}_blocks"
        setattr(self.stats, name, getattr(self.stats, name) + n)

    # ------------------------------------------------------------------- put
    def put_batch(
        self,
        tokens: Sequence[int],
        blocks: Sequence[np.ndarray],
        start_block: int = 0,
        skip_existing: bool = True,
    ) -> int:
        """Store ``blocks[i]`` as the KV cache of tokens
        ``[(start_block+i)·B : (start_block+i+1)·B)``.  Returns #blocks
        written (duplicates skipped)."""
        B = self.block_size
        t0 = time.perf_counter()
        records = []  # (key, payload)
        bytes_in = bytes_stored = 0
        # encode outside the mutation lock: codec CPU (quantize + zlib) is
        # the expensive part and must not serialize concurrent writers
        # across shards sharing a thread pool.  The dedup check may race a
        # concurrent writer of the same key; the loser's record becomes
        # garbage the merge service collects — never a lost write.
        for i, block in enumerate(blocks):
            bi = start_block + i
            end = (bi + 1) * B
            if end > len(tokens):
                break
            key = self._key(tokens, end)
            if skip_existing:
                found, _ = self.index.get(key)
                if found:
                    continue
            payload = self.codec.encode(np.asarray(block))
            bytes_in += np.asarray(block).nbytes
            bytes_stored += len(payload)
            records.append((key, payload))
        if not records:
            return 0
        with self._lock:
            # phase 1: tensor log append.  Durability ordering: with
            # fsync_writes the log was constructed with fsync-per-append,
            # so the payload bytes are on disk *before* phase 2's WAL-backed
            # index insert can commit a pointer to them (the same internal
            # fsync also covers the merge service's relocation appends).
            ptrs = self.log.append_batch(records)
            # phase 2: atomic index insert (WAL-backed commit point).  The
            # flags byte carries the block's compression tier.
            self.index.put_batch(
                (k, self._pack_value(p, self._put_tier)) for (k, _), p in zip(records, ptrs)
            )
        with self._stats_lock:
            self.controller.record(OP_WRITE, len(records))
            self.stats.payload_bytes_in += bytes_in
            self.stats.payload_bytes_stored += bytes_stored
            self.stats.put_blocks += len(records)
            self.stats.put_tokens += len(records) * B
            self.stats.io_write_s += time.perf_counter() - t0
            self._bump_tier(self._put_tier, len(records))
        return len(records)

    # ----------------------------------------------------------------- probe
    def probe(self, tokens: Sequence[int]) -> int:
        """Longest cached prefix length in tokens (multiple of block_size).
        Binary search over block counts; each step is an LSM point lookup
        (paper App. B: Bloom filters prune the misses).  Traced as
        ``store.probe``."""
        with maybe_span("store.probe"):
            return self._probe(tokens)

    def _probe(self, tokens: Sequence[int]) -> int:
        B = self.block_size
        max_blocks = len(tokens) // B
        with self._stats_lock:
            self.stats.probes += 1
        if max_blocks == 0:
            with self._stats_lock:
                self.stats.probe_empty += 1
                self.controller.record(OP_EMPTY, 1)
            return 0
        lo, hi = 0, max_blocks  # invariant: block count `lo` exists (0 = root)
        while lo < hi:
            mid = (lo + hi + 1) // 2
            found, _ = self.index.get(self._key(tokens, mid * B))
            with self._stats_lock:
                self.stats.probe_lookups += 1
                self.controller.record(OP_READ if found else OP_EMPTY, 1)
            if found:
                lo = mid
            else:
                hi = mid - 1
        if lo and self._may_have_holes:
            # Binary search assumes prefix-closure (block k present => blocks
            # 1..k-1 present), but FIFO file eviction tombstones whole files
            # regardless of prefix position, punching holes mid-prefix.  One
            # index range scan confirms the contiguous prefix so probe never
            # promises tokens get_batch would then truncate.  Skipped until
            # the first eviction: hole-free stores keep the pure O(log n)
            # Bloom-pruned probe.
            lo = self._contiguous_blocks(tokens, lo)
        with self._stats_lock:
            if lo == 0:
                self.stats.probe_empty += 1
            else:
                self.stats.probe_hits += 1
        return lo * B

    def _scan_block_ptrs(self, tokens: Sequence[int], n_blocks: int) -> List[Optional[LogPointer]]:
        """One index range scan over blocks 1..n_blocks; ``ptrs[i]`` is None
        when block ``i+1`` is absent.  Shared by ``get_batch`` and probe's
        contiguity verification so the two can never disagree on presence."""
        B = self.block_size
        start = self._key(tokens, B)
        end = self._key(tokens, n_blocks * B) + b"\x00"
        wanted: Dict[bytes, int] = {self._key(tokens, (i + 1) * B): i for i in range(n_blocks)}
        ptrs: List[Optional[LogPointer]] = [None] * n_blocks
        for k, v in self.index.range(start, end):
            idx = wanted.get(k)
            if idx is not None:
                ptrs[idx] = self._unpack_value(v)
        with self._stats_lock:
            self.controller.record(OP_RANGE, 1)
        return ptrs

    def _contiguous_blocks(self, tokens: Sequence[int], n_blocks: int) -> int:
        """Largest k <= n_blocks such that blocks 1..k are all indexed."""
        ptrs = self._scan_block_ptrs(tokens, n_blocks)
        k = 0
        while k < n_blocks and ptrs[k] is not None:
            k += 1
        return k

    # ------------------------------------------------------------------- get
    def get_batch(
        self, tokens: Sequence[int], n_tokens: int, start_block: int = 0
    ) -> List[np.ndarray]:
        """Load the cached blocks covering ``tokens[:n_tokens]``, from block
        index ``start_block`` on: ``get_batch(tokens, n_tokens)[start_block:]``.
        One index range scan finds the contiguous cached run from block 0;
        a coalesced batch read from the tensor log then reads and decodes
        only its blocks from ``start_block`` on.  Traced as ``store.scan``,
        ``store.read`` and ``store.decode`` (units: the blocks read and
        decoded), once each a call."""
        B = self.block_size
        n_blocks = n_tokens // B
        if n_blocks <= start_block:
            return []
        t0 = time.perf_counter()
        out: List[np.ndarray] = []
        pooled = 0
        # Optimistic lock-free read: resolve pointers, read payloads with no
        # lock held.  If FIFO eviction or the merge service removed a log
        # file between the scan and the read (FileNotFoundError), re-resolve
        # and retry — the index was updated (tombstoned or repointed)
        # *before* the file was unlinked, so a fresh scan converges.  Any
        # other I/O error (notably a CRC mismatch: records are immutable
        # once their pointer is published, so a bad checksum is real
        # corruption, never a race) propagates to the caller.  Bounded
        # attempts: a reader can lose the eviction race at most once per
        # maintenance cycle in practice.
        for _attempt in range(3):
            with maybe_span("store.scan"):
                ptrs = self._scan_block_ptrs(tokens, n_blocks)
            # only the contiguous prefix is usable as KV cache
            run = ptrs.index(None) if None in ptrs else n_blocks
            wanted = ptrs[start_block:run]
            if not wanted:
                break
            try:
                with maybe_span("store.read", units=len(wanted)):
                    recs = self.log.read_batch(wanted)
            except FileNotFoundError:
                continue  # lost the race with eviction/merge: retry
            with maybe_span("store.decode", units=len(recs)):
                out, pooled = _decode_records([payload for _, payload in recs])
            break
        with self._stats_lock:
            self.stats.pooled_decode_blocks += pooled
            self.stats.get_blocks += len(out)
            self.stats.get_tokens += len(out) * B
            self.stats.io_read_s += time.perf_counter() - t0
        return out

    def get_batch_encoded(self, tokens: Sequence[int], n_tokens: int) -> List[bytes]:
        """The contiguous cached prefix as *encoded* codec payloads —
        no decode.  The cluster server ships these verbatim, so the wire
        carries the same compressed bytes the disk stores (the buffered
        complement of the sendfile path, which already ships raw log
        records).  Payloads are self-describing (``core.codec`` header);
        the receiver decodes with ``BatchCodec.decode``."""
        B = self.block_size
        n_blocks = n_tokens // B
        if n_blocks == 0:
            return []
        t0 = time.perf_counter()
        payloads: List[Optional[bytes]] = [None] * n_blocks
        for _attempt in range(3):  # same retry contract as get_batch
            ptrs = self._scan_block_ptrs(tokens, n_blocks)
            present = [(i, p) for i, p in enumerate(ptrs) if p is not None]
            payloads = [None] * n_blocks
            if not present:
                break
            try:
                recs = self.log.read_batch([p for _, p in present])
            except FileNotFoundError:
                continue  # lost the race with eviction/merge/demotion: retry
            for (i, _), (_, payload) in zip(present, recs):
                payloads[i] = bytes(payload)
            break
        out: List[bytes] = []
        for p in payloads:
            if p is None:
                break
            out.append(p)
        with self._stats_lock:
            self.stats.get_blocks += len(out)
            self.stats.get_tokens += len(out) * B
            self.stats.io_read_s += time.perf_counter() - t0
        return out

    def get_batch_raw(self, tokens: Sequence[int], n_tokens: int) -> Optional[RawBatch]:
        """Zero-copy variant of ``get_batch``: when the contiguous cached
        prefix sits as one adjacent run of records in a single tensor-log
        file (the common case — a sequence is appended in one batch),
        return it as an open-file extent instead of reading and decoding.
        Returns ``None`` when no such extent exists (blocks span files,
        interleave with other writes, or the store is empty) — callers
        fall back to ``get_batch``."""
        B = self.block_size
        n_blocks = n_tokens // B
        if n_blocks == 0:
            return None
        ptrs = self._scan_block_ptrs(tokens, n_blocks)
        run = []
        for p in ptrs:
            if p is None:
                break
            run.append(p)
        if not run:
            return None
        ext = self.log.extent_for(run)
        if ext is None:
            return None
        try:
            f = open(ext.path, "rb")
        except FileNotFoundError:
            return None  # lost the race with eviction/merge; caller retries decoded
        self.log.touch(run[0].file_id)  # sendfile reads count as access too
        with self._stats_lock:
            self.stats.raw_gets += 1
            self.stats.raw_get_blocks += len(run)
        return RawBatch(file=f, offset=ext.offset, length=ext.length,
                        record_lengths=list(ext.record_lengths))

    # ----------------------------------------------- key export (elasticity)
    # The enumeration/export/import trio is the storage-level substrate of
    # cluster migration (``cluster.migration``): scan the live keyspace in
    # pages, ship blocks *in their stored encoding* (cold tiers migrate
    # compressed — no transcode on either side), and accept foreign records
    # verbatim.  All three are optional backend methods (duck-typed by the
    # cluster server, like ``get_batch_encoded``).

    _SCAN_END = b"\xff" * 2048  # past any real key (keys are 4B/token)

    def scan_keys(
        self, cursor: Optional[bytes] = None, limit: int = 1024
    ) -> "tuple[List[bytes], Optional[bytes]]":
        """One page of live index keys in key order, starting strictly
        after ``cursor`` (None = from the beginning).  Returns
        ``(keys, next_cursor)``; ``next_cursor`` is None once the keyspace
        is exhausted.  Key order sorts every prefix before its extensions,
        so a prefix tree streams out in prefix-closed order — a migration
        destination that imports pages in order never holds a child block
        without its ancestors.  A page may be shorter than ``limit`` (or
        the final ``next_cursor`` may point at an empty page); callers
        loop until ``next_cursor`` is None."""
        start = bytes(cursor) + b"\x00" if cursor else b""
        out: List[bytes] = []
        for k, _ in self.index.range(start, self._SCAN_END):
            out.append(k)
            if len(out) >= limit:
                break
        next_cursor = out[-1] if len(out) >= limit else None
        return out, next_cursor

    def export_encoded(self, keys: Sequence[bytes]):
        """Stored records for ``keys`` as ``(tier_flags, payload)`` pairs
        (still encoded — the wire ships what the disk stores), aligned
        with ``keys``; ``None`` where a key is not (or no longer) indexed.
        Same optimistic retry contract as ``get_batch``: losing a race
        with eviction/merge re-resolves from the index."""
        out: List[Optional[tuple]] = [None] * len(keys)
        n = 0
        for _attempt in range(3):
            present = []
            for i, key in enumerate(keys):
                found, v = self.index.get(bytes(key))
                if found:
                    present.append((i, *self._unpack_entry(v)))
            out = [None] * len(keys)
            if not present:
                break
            try:
                recs = self.log.read_batch([ptr for _, ptr, _ in present])
            except FileNotFoundError:
                continue  # lost the race with eviction/merge/demotion: retry
            for (i, _, flags), (_, payload) in zip(present, recs):
                out[i] = (flags, bytes(payload))
            n = len(present)
            break
        with self._stats_lock:
            self.stats.exported_blocks += n
        return out

    def import_encoded(self, records, skip_existing: bool = True) -> int:
        """Accept foreign ``(key, tier_flags, payload)`` records verbatim:
        the payload is appended to the tensor log unchanged and indexed
        with its original tier flags, so a block that left its source as
        int8+zlib lands here as int8+zlib.  Idempotent under
        ``skip_existing`` (already-indexed keys are skipped and not
        counted), which is what makes migration retries and multi-source
        repair copies safe.  Returns the number of blocks written."""
        fresh = []  # (key, payload)
        flags_list: List[int] = []
        for key, flags, payload in records:
            key = bytes(key)
            if skip_existing:
                found, _ = self.index.get(key)
                if found:
                    continue
            fresh.append((key, bytes(payload)))
            flags_list.append(int(flags) & 0xFF)
        if not fresh:
            return 0
        with self._lock:
            # Imported arcs are subsets of the source keyspace, so this
            # store can now hold blocks without their prefix ancestors —
            # same probe-safety situation as file eviction.  Persist the
            # marker *before* the records commit so probe verifies
            # contiguity from the first imported block onward.
            if not self._may_have_holes:
                self._may_have_holes = True
                open(self._holes_marker, "w").close()
            # two-phase write, same ordering as put_batch
            ptrs = self.log.append_batch(fresh)
            self.index.put_batch(
                (k, self._pack_value(p, fl))
                for (k, _), p, fl in zip(fresh, ptrs, flags_list)
            )
        nbytes = sum(len(p) for _, p in fresh)
        with self._stats_lock:
            self.controller.record(OP_WRITE, len(fresh))
            self.stats.imported_blocks += len(fresh)
            self.stats.imported_bytes += nbytes
            self.stats.payload_bytes_stored += nbytes
            for fl in flags_list:
                self._bump_tier(fl & TIER_MASK, 1)
        return len(fresh)

    # ------------------------------------------------------------ lifecycle
    def maintenance(self, compact_steps: int = 8) -> dict:
        """One maintenance cycle: index compaction, tensor-file merging, and
        budget eviction.  Deterministic (no background thread) so tests and
        benchmarks control scheduling; ``serving.engine`` calls it between
        batches, mirroring the paper's 'scheduled compaction cycles'."""
        with self._lock:
            rep: dict = {}
            rep["compactions"] = self.index.maybe_compact(compact_steps)
            if self.merger.needed():
                m = self.merger.run()
                rep["merge"] = {"files": m.files_removed, "moved": m.records_moved, "reclaimed": m.bytes_reclaimed}
            # tier demotion runs before budget eviction so the budget is
            # enforced against the *compressed* footprint — this ordering
            # is what lets a fixed budget hold 3-4x more cold blocks
            if self.recoder is not None and self.recoder.needed():
                t0 = time.perf_counter()
                trep = self.recoder.run()
                self._apply_tier_report(trep, time.perf_counter() - t0)
                if trep.files:
                    rep["tiering"] = trep.as_dict()
            if self.budget_bytes is not None:
                rep["evicted_files"] = self._evict_to_budget()
            return rep

    def _apply_tier_report(self, trep, dt: float) -> None:
        with self._stats_lock:
            self.stats.demoted_blocks += trep.demoted_blocks
            self.stats.demote_bytes_before += trep.bytes_before
            self.stats.demote_bytes_after += trep.bytes_after
            self.stats.demote_s += dt
            for name, n in trep.transitions.items():
                src, _, dst = name.partition("->")
                self._bump_tier(TIER_NAMES.index(src), -n)
                self._bump_tier(TIER_NAMES.index(dst), n)

    def evict_oldest_file(self) -> bool:
        """Drop the oldest tensor-log file and tombstone its index entries
        (the unit of FIFO eviction; ``ShardedKVBlockStore`` drives this
        directly to enforce a global budget across shards).  Returns False
        when only the active file remains.  Index entries are tombstoned
        *before* the file is unlinked so concurrent lock-free readers that
        lose the race re-resolve to a consistent (evicted) view."""
        with self._lock:
            if self.log.file_count <= 1:
                return False
            if not self._may_have_holes:
                self._may_have_holes = True
                open(self._holes_marker, "w").close()
            fid = self.log.file_ids()[0]
            keys = [key for _, key, _ in self.log.scan_file(fid)]
            # one batched tombstone insert (single WAL sync under
            # fsync_writes) instead of a per-key delete loop
            dead = []
            tiers = [0, 0, 0]  # evicted blocks per compression tier
            for key in keys:
                found, v = self.index.get(key)
                if found and self._unpack_value(v).file_id == fid:
                    dead.append(key)
                    tiers[self._unpack_entry(v)[1] & TIER_MASK] += 1
            self.index.put_batch((k, None) for k in dead)
            evicted = len(dead)
            self.log.remove_file(fid)
        with self._stats_lock:
            self.stats.evicted_blocks += evicted
            for tier, n in enumerate(tiers):
                if n:
                    self._bump_tier(tier, -n)
        return True

    def _evict_to_budget(self) -> int:
        """FIFO file eviction: oldest tensor-log files are dropped (their
        index entries tombstoned) until under budget.  Hot data survives
        because the merge service continuously rewrites live records into
        young files (WiscKey-style age segregation)."""
        evicted = 0
        while self.disk_bytes > self.budget_bytes and self.evict_oldest_file():
            evicted += 1
        return evicted

    # ----------------------------------------------------------------- stats
    @property
    def disk_bytes(self) -> int:
        return self.log.total_bytes + self.index.disk_bytes

    @property
    def file_count(self) -> int:
        return self.log.file_count + self.index.n_runs

    @property
    def write_amplification(self) -> float:
        return self.index.stats.write_amplification

    def flush(self) -> None:
        with self._lock:
            self.index.flush()
            self.log.sync()

    def sync_wal(self) -> None:
        """Durability point without a memtable flush: tensor log first, then
        the WAL (same ordering as the two-phase write), so recovery replays
        an index whose pointers all resolve."""
        with self._lock:
            self.log.sync()
            self.index.wal.sync()

    def close(self) -> None:
        with self._lock:
            self.index.close()
            self.log.close()
