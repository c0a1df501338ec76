"""Sorted-run (SSTable) file format with fence pointers, restart-point
prefix compression, and a per-run Bloom filter.

Layout::

    [data block 0][data block 1]...[index][bloom][footer(40B)]

Data block entry (LevelDB-style):
    varint shared_len | varint unshared_len | varint value_len |
    key_suffix bytes | value bytes
Tombstones are encoded with value_len == VLEN_TOMBSTONE sentinel.

Prefix compression matters here more than in a general-purpose store: keys
are full token prefixes (``keycodec``), so consecutive keys within a run
share very long prefixes — a 32k-token key typically costs ~4 bytes of
suffix after compression.

The index (fence pointers) and Bloom filter are loaded into memory when the
run is opened; data blocks are read on demand (one seek + one read per
block), matching the I/O cost model of §2.2.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

from .bloom import BloomFilter
from .keycodec import shared_prefix_len

MAGIC = 0x4C534D31  # "LSM1"
_FOOTER = struct.Struct("<QQQQI")  # index_off, index_len, bloom_off, bloom_len, magic
VLEN_TOMBSTONE = (1 << 32) - 1


def _put_varint(buf: bytearray, n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def _get_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift = 0
    out = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


@dataclass
class RunMeta:
    path: str
    min_key: bytes
    max_key: bytes
    entries: int
    data_bytes: int  # total file size
    seq: int  # creation sequence number; larger == newer


class SSTWriter:
    """Builds one sorted run from an already-sorted (key, value) stream."""

    def __init__(self, path: str, block_bytes: int = 4096, bloom_bits_per_key: float = 10.0):
        self.path = path
        self.block_bytes = block_bytes
        self._bloom_bits = bloom_bits_per_key
        self._buf = bytearray()
        self._last_key: Optional[bytes] = None
        self._block_first_key: Optional[bytes] = None
        self._index: List[Tuple[bytes, int, int]] = []  # (first_key, off, len)
        self._keys: List[bytes] = []
        self._f = open(path, "wb")
        self._off = 0
        self.entries = 0
        self.min_key: Optional[bytes] = None
        self.max_key: Optional[bytes] = None

    def add(self, key: bytes, value: Optional[bytes]) -> None:
        if self._last_key is not None and key <= self._last_key:
            raise ValueError("keys must be added in strictly increasing order")
        if self._block_first_key is None:
            self._block_first_key = key
            shared = 0  # restart point at block start
        else:
            shared = shared_prefix_len(self._last_key, key)
        _put_varint(self._buf, shared)
        _put_varint(self._buf, len(key) - shared)
        _put_varint(self._buf, VLEN_TOMBSTONE if value is None else len(value))
        self._buf += key[shared:]
        if value is not None:
            self._buf += value
        self._last_key = key
        self._keys.append(key)
        self.entries += 1
        if self.min_key is None:
            self.min_key = key
        self.max_key = key
        if len(self._buf) >= self.block_bytes:
            self._flush_block()

    def _flush_block(self) -> None:
        if not self._buf:
            return
        raw = bytes(self._buf)
        self._f.write(raw)
        self._index.append((self._block_first_key, self._off, len(raw)))
        self._off += len(raw)
        self._buf.clear()
        self._block_first_key = None
        self._last_key = None  # restart prefix compression at block boundary

    def finish(self) -> RunMeta:
        self._flush_block()
        # index block: count | per entry: varint klen, key, u64 off, u32 len
        ib = bytearray()
        _put_varint(ib, len(self._index))
        for fk, off, ln in self._index:
            _put_varint(ib, len(fk))
            ib += fk
            ib += struct.pack("<QI", off, ln)
        index_raw = zlib.compress(bytes(ib), 1)
        bloom = BloomFilter.for_entries(len(self._keys), self._bloom_bits)
        for k in self._keys:
            bloom.add(k)
        bloom_raw = bloom.to_bytes()
        index_off = self._off
        self._f.write(index_raw)
        bloom_off = index_off + len(index_raw)
        self._f.write(bloom_raw)
        self._f.write(_FOOTER.pack(index_off, len(index_raw), bloom_off, len(bloom_raw), MAGIC))
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        size = os.path.getsize(self.path)
        return RunMeta(
            path=self.path,
            min_key=self.min_key or b"",
            max_key=self.max_key or b"",
            entries=self.entries,
            data_bytes=size,
            seq=0,
        )


def _decode_block(raw: bytes) -> Iterator:
    pos = 0
    prev = b""
    n = len(raw)
    while pos < n:
        shared, pos = _get_varint(raw, pos)
        unshared, pos = _get_varint(raw, pos)
        vlen, pos = _get_varint(raw, pos)
        key = prev[:shared] + raw[pos : pos + unshared]
        pos += unshared
        if vlen == VLEN_TOMBSTONE:
            value = None
        else:
            value = raw[pos : pos + vlen]
            pos += vlen
        yield key, value
        prev = key


class SSTReader:
    """Open run: fence pointers + bloom in memory, blocks read on demand."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self._f.seek(0, os.SEEK_END)
        fsize = self._f.tell()
        self._f.seek(fsize - _FOOTER.size)
        index_off, index_len, bloom_off, bloom_len, magic = _FOOTER.unpack(self._f.read(_FOOTER.size))
        if magic != MAGIC:
            raise IOError(f"bad SST magic in {path}")
        self._f.seek(index_off)
        ib = zlib.decompress(self._f.read(index_len))
        pos = 0
        cnt, pos = _get_varint(ib, pos)
        self.index: List[Tuple[bytes, int, int]] = []
        for _ in range(cnt):
            klen, pos = _get_varint(ib, pos)
            fk = ib[pos : pos + klen]
            pos += klen
            off, ln = struct.unpack_from("<QI", ib, pos)
            pos += 12
            self.index.append((fk, off, ln))
        self._f.seek(bloom_off)
        self.bloom = BloomFilter.from_bytes(self._f.read(bloom_len))
        self.block_reads = 0  # observability for cost-model validation

    def close(self) -> None:
        self._f.close()

    def _read_block(self, i: int) -> bytes:
        _, off, ln = self.index[i]
        self._f.seek(off)
        self.block_reads += 1
        return self._f.read(ln)

    def _find_block(self, key: bytes) -> int:
        """Rightmost block whose first_key <= key (fence-pointer search)."""
        lo, hi = 0, len(self.index) - 1
        ans = -1
        while lo <= hi:
            mid = (lo + hi) // 2
            if self.index[mid][0] <= key:
                ans = mid
                lo = mid + 1
            else:
                hi = mid - 1
        return ans

    def get(self, key: bytes):
        """(found, value) — bloom-pruned point lookup."""
        if key not in self.bloom:
            return False, None
        bi = self._find_block(key)
        if bi < 0:
            return False, None
        for k, v in _decode_block(self._read_block(bi)):
            if k == key:
                return True, v
            if k > key:
                break
        return False, None

    def range(self, start: bytes, end: bytes) -> Iterator:
        """Yield (key, value) for start <= key < end (tombstones included)."""
        if not self.index:
            return
        bi = max(0, self._find_block(start))
        for i in range(bi, len(self.index)):
            if self.index[i][0] >= end:
                break
            for k, v in _decode_block(self._read_block(i)):
                if k < start:
                    continue
                if k >= end:
                    return
                yield k, v

    def items(self) -> Iterator:
        for i in range(len(self.index)):
            yield from _decode_block(self._read_block(i))
