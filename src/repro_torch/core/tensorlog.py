"""Tensor log: the value side of key-value separation (paper §3.2,
WiscKey-style).  Large immutable KV-cache payloads are appended to
sequential log files; the LSM index stores only ``(file_id, offset,
length)`` pointers.  Compaction of the index never touches these files,
bounding write amplification.

Record layout (self-describing so the merge service can relocate records
without consulting the index)::

    u32 crc | u32 klen | u32 plen | key | payload

Batch reads coalesce adjacent ``(file, offset)`` ranges into single
sequential reads — this is the mechanism that converts the file-per-object
random-I/O pattern into sequential I/O (paper App. B, Get Batch).

Concurrency: appends, file removal, and the size/liveness bookkeeping are
serialized by an internal lock; **reads take no lock at all**.  Log records
are immutable once their pointer is published (append flushes before the
index insert that publishes the pointer), file ids are never reused, and
readers open their own file handles — so the only read/write race is a
reader holding a pointer into a file that eviction or the merge service
just removed, which surfaces as ``FileNotFoundError`` and is handled by
the store's read-retry loop (re-resolve pointers from the index).
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Dict, Iterator, List, Sequence, Tuple

_HDR = struct.Struct("<III")


@dataclass(frozen=True)
class LogExtent:
    """A run of whole records that is byte-contiguous in one log file —
    the unit the cluster server can ``os.sendfile`` straight into a
    socket.  ``record_lengths`` preserves the per-record boundaries so
    the sender can split the extent at record granularity."""

    path: str
    offset: int
    length: int
    record_lengths: Tuple[int, ...]


@dataclass(frozen=True)
class LogPointer:
    file_id: int
    offset: int
    length: int  # full record length (header + key + payload)

    def pack(self) -> bytes:
        return struct.pack("<QQI", self.file_id, self.offset, self.length)

    @classmethod
    def unpack(cls, raw: bytes) -> "LogPointer":
        f, o, l = struct.unpack_from("<QQI", raw)
        return cls(f, o, l)

PTR_BYTES = struct.calcsize("<QQI")


class TensorLog:
    def __init__(self, root: str, max_file_bytes: int = 64 * 1024 * 1024, fsync_writes: bool = False):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.max_file_bytes = max_file_bytes
        self.fsync_writes = fsync_writes
        self._lock = threading.RLock()  # guards appends + bookkeeping; reads are lock-free
        self._files: Dict[int, dict] = {}  # id -> {size, live, path, atime}
        self._active_id = -1
        self._active_f = None
        self.seq_reads = 0
        self._recover()

    # -- bookkeeping ---------------------------------------------------------
    def _path(self, file_id: int) -> str:
        return os.path.join(self.root, f"vlog_{file_id:08d}.bin")

    def _recover(self) -> None:
        ids = []
        for name in os.listdir(self.root):
            if name.startswith("vlog_") and name.endswith(".bin"):
                fid = int(name[5:-4])
                ids.append(fid)
                size = os.path.getsize(self._path(fid))
                self._files[fid] = {"size": size, "live": size,
                                    "path": self._path(fid),
                                    "atime": time.monotonic()}
        self._active_id = max(ids) if ids else -1

    def _open_active(self) -> None:
        if self._active_f is None or self._files.get(self._active_id, {}).get("size", 0) >= self.max_file_bytes:
            if self._active_f is not None:
                self._active_f.close()
            self._active_id += 1
            self._files[self._active_id] = {"size": 0, "live": 0,
                                            "path": self._path(self._active_id),
                                            "atime": time.monotonic()}
            self._active_f = open(self._path(self._active_id), "ab")

    @property
    def file_count(self) -> int:
        with self._lock:
            return len(self._files)

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return sum(f["size"] for f in self._files.values())

    def garbage_ratio(self, file_id: int) -> float:
        with self._lock:
            f = self._files[file_id]
            return 1.0 - (f["live"] / f["size"]) if f["size"] else 0.0

    def file_ids(self) -> List[int]:
        with self._lock:
            return sorted(self._files)

    # -- access recency (tier policy input) ----------------------------------
    def touch(self, file_id: int) -> None:
        """Refresh a file's last-access time.  Lock-free by design: called
        from the read path, where a single dict-slot assignment is safe
        under CPython and an occasionally-lost update only ages a file a
        little early — the tier policy tolerates that."""
        f = self._files.get(file_id)
        if f is not None:
            f["atime"] = time.monotonic()

    def idle_s(self, file_id: int, now: float = None) -> float:
        """Seconds since the file was last appended to or read from — the
        access-recency signal ``core.tiering`` demotes on."""
        f = self._files.get(file_id)
        if f is None:
            return 0.0
        return (time.monotonic() if now is None else now) - f["atime"]

    # -- writes --------------------------------------------------------------
    def append(self, key: bytes, payload: bytes) -> LogPointer:
        return self.append_batch([(key, payload)])[0]

    def append_batch(self, records: Sequence[Tuple[bytes, bytes]]) -> List[LogPointer]:
        """Append records contiguously; one write syscall for the batch.
        Serialized by the log lock; the flush before return makes every
        returned pointer immediately readable by lock-free readers."""
        with self._lock:
            return self._append_batch_locked(records)

    def _append_batch_locked(self, records: Sequence[Tuple[bytes, bytes]]) -> List[LogPointer]:
        self._open_active()
        finfo = self._files[self._active_id]
        base = finfo["size"]
        buf = bytearray()
        ptrs: List[LogPointer] = []
        for key, payload in records:
            body = key + payload
            crc = zlib.crc32(body) & 0xFFFFFFFF
            rec = _HDR.pack(crc, len(key), len(payload)) + body
            ptrs.append(LogPointer(self._active_id, base + len(buf), len(rec)))
            buf += rec
        self._active_f.write(buf)
        self._active_f.flush()  # readers use separate handles
        if self.fsync_writes:
            os.fsync(self._active_f.fileno())
        finfo["size"] += len(buf)
        finfo["live"] += len(buf)
        finfo["atime"] = time.monotonic()
        return ptrs

    def mark_dead(self, ptr: LogPointer) -> None:
        with self._lock:
            f = self._files.get(ptr.file_id)
            if f is not None:
                f["live"] = max(0, f["live"] - ptr.length)

    # -- reads ---------------------------------------------------------------
    def read(self, ptr: LogPointer) -> Tuple[bytes, bytes]:
        with open(self._path(ptr.file_id), "rb") as f:
            f.seek(ptr.offset)
            raw = f.read(ptr.length)
        self.touch(ptr.file_id)
        return self._parse(raw, ptr)

    @staticmethod
    def _parse(raw, ptr: LogPointer) -> Tuple[bytes, "memoryview"]:
        """Parse one record.  ``raw`` may be bytes or a memoryview into a
        larger read; the returned payload is a zero-copy view — per-block
        GIL-held memcpys were a measurable serial fraction of batch reads.
        CRC runs over the view (crc32 releases the GIL on large buffers)."""
        crc, klen, plen = _HDR.unpack_from(raw)
        body = memoryview(raw)[_HDR.size : _HDR.size + klen + plen]
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            raise IOError(f"tensor-log CRC mismatch at {ptr}")
        return bytes(body[:klen]), body[klen:]

    def read_batch(self, ptrs: Sequence[LogPointer]) -> List[Tuple[bytes, bytes]]:
        """Coalescing batch read: pointers are grouped per file, sorted by
        offset, and adjacent/overlapping ranges are fetched with a single
        sequential read."""
        by_file: Dict[int, List[Tuple[int, LogPointer]]] = {}
        for i, p in enumerate(ptrs):
            by_file.setdefault(p.file_id, []).append((i, p))
        out: List = [None] * len(ptrs)
        seq_reads = 0
        for fid, lst in by_file.items():
            lst.sort(key=lambda ip: ip[1].offset)
            with open(self._path(fid), "rb") as f:
                j = 0
                while j < len(lst):
                    # coalesce a contiguous-ish range (gap tolerance 64 KiB)
                    start = lst[j][1].offset
                    end = lst[j][1].offset + lst[j][1].length
                    k = j + 1
                    while k < len(lst) and lst[k][1].offset <= end + 65536:
                        end = max(end, lst[k][1].offset + lst[k][1].length)
                        k += 1
                    f.seek(start)
                    chunk = memoryview(f.read(end - start))
                    seq_reads += 1
                    for idx, p in lst[j:k]:
                        raw = chunk[p.offset - start : p.offset - start + p.length]
                        out[idx] = self._parse(raw, p)
                    j = k
            self.touch(fid)
        with self._lock:
            self.seq_reads += seq_reads
        return out

    def extent_for(self, ptrs: Sequence[LogPointer]) -> "LogExtent | None":
        """The single contiguous extent covering ``ptrs`` in order, or
        ``None`` when the records span files or are not strictly
        adjacent.  Batch appends write records back-to-back, so a
        sequence stored in one ``append_batch`` call (the common case:
        one ``put_batch`` per sequence) qualifies."""
        if not ptrs:
            return None
        fid, off = ptrs[0].file_id, ptrs[0].offset
        end = off
        for p in ptrs:
            if p.file_id != fid or p.offset != end:
                return None
            end += p.length
        return LogExtent(self._path(fid), off, end - off, tuple(p.length for p in ptrs))

    def scan_file(self, file_id: int) -> Iterator:
        """Yield (ptr, key, payload) for every record in a file (merge/GC)."""
        path = self._path(file_id)
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            off = 0
            while off + _HDR.size <= size:
                hdr = f.read(_HDR.size)
                crc, klen, plen = _HDR.unpack_from(hdr)
                body = f.read(klen + plen)
                if len(body) < klen + plen:
                    return
                ptr = LogPointer(file_id, off, _HDR.size + klen + plen)
                if zlib.crc32(body) & 0xFFFFFFFF == crc:
                    yield ptr, body[:klen], body[klen:]
                off += ptr.length

    def remove_file(self, file_id: int) -> None:
        with self._lock:
            if self._active_id == file_id and self._active_f is not None:
                self._active_f.close()
                self._active_f = None
            try:
                os.remove(self._path(file_id))
            except OSError:
                pass
            self._files.pop(file_id, None)

    def sync(self) -> None:
        with self._lock:
            if self._active_f is not None:
                self._active_f.flush()
                os.fsync(self._active_f.fileno())

    def close(self) -> None:
        with self._lock:
            if self._active_f is not None:
                self._active_f.close()
                self._active_f = None
