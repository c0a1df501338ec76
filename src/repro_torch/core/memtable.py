"""In-memory write buffer of the LSM-tree (paper Fig. 2).

Keeps keys in sorted order (bisect-maintained list) so flushes emit an
already-sorted run and range scans can merge the memtable with on-disk runs.
Tombstones are represented as ``value is None``.
"""

from __future__ import annotations

import bisect
from typing import Iterator, Optional

_MISSING = object()


class MemTable:
    def __init__(self) -> None:
        self._map: dict = {}
        self._keys: list = []  # sorted
        self.bytes = 0  # approximate payload bytes

    def __len__(self) -> int:
        return len(self._map)

    def put(self, key: bytes, value: Optional[bytes]) -> None:
        old = self._map.get(key, _MISSING)
        if old is _MISSING:
            bisect.insort(self._keys, key)
            self.bytes += len(key)
        else:
            self.bytes -= len(old) if old is not None else 0
        self._map[key] = value
        self.bytes += len(value) if value is not None else 0

    def get(self, key: bytes):
        """Returns (found, value).  value None => tombstone."""
        v = self._map.get(key, _MISSING)
        if v is _MISSING:
            return False, None
        return True, v

    def range(self, start: bytes, end: bytes) -> Iterator:
        """Yield (key, value) for start <= key < end, in order (tombstones
        included so the merge layer can shadow older runs)."""
        lo = bisect.bisect_left(self._keys, start)
        hi = bisect.bisect_left(self._keys, end)
        for i in range(lo, hi):
            k = self._keys[i]
            yield k, self._map[k]

    def items(self) -> Iterator:
        for k in self._keys:
            yield k, self._map[k]

    def clear(self) -> None:
        self._map.clear()
        self._keys.clear()
        self.bytes = 0
