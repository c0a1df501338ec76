"""Write-ahead log + versioned manifest: crash consistency for the LSM index
(paper §3.2's two-phase write protocol relies on the index insert being the
atomic commit point; the WAL makes that insert durable, and the manifest
makes structural changes — flushes, compactions, log merges — atomic).

WAL record::

    u32 crc | u32 klen | u32 vlen(or TOMBSTONE) | key | value

Manifest: JSON written to ``MANIFEST-<n>`` then atomically pointed at by a
``CURRENT`` file (write-temp + rename).  Recovery = read CURRENT, load
manifest, replay WAL into a fresh memtable.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Iterator, List, Optional, Tuple

_HDR = struct.Struct("<III")
_TOMB = 0xFFFFFFFF


class WAL:
    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "ab")

    def append(self, key: bytes, value: Optional[bytes]) -> None:
        vlen = _TOMB if value is None else len(value)
        body = key + (value or b"")
        crc = zlib.crc32(body) & 0xFFFFFFFF
        self._f.write(_HDR.pack(crc, len(key), vlen) + body)

    def sync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        self._f.close()

    @staticmethod
    def replay(path: str) -> Iterator:
        """Yield (key, value) records; stops at first torn/corrupt record
        (crash semantics: a torn tail is discarded, not an error)."""
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            raw = f.read()
        pos = 0
        n = len(raw)
        while pos + _HDR.size <= n:
            crc, klen, vlen = _HDR.unpack_from(raw, pos)
            pos2 = pos + _HDR.size
            vl = 0 if vlen == _TOMB else vlen
            if pos2 + klen + vl > n:
                return  # torn tail
            body = raw[pos2 : pos2 + klen + vl]
            if zlib.crc32(body) & 0xFFFFFFFF != crc:
                return  # corrupt tail
            key = body[:klen]
            value = None if vlen == _TOMB else body[klen:]
            yield key, value
            pos = pos2 + klen + vl


class ManifestStore:
    """Versioned manifest with atomic install."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._next = self._scan_next()

    def _scan_next(self) -> int:
        mx = 0
        for name in os.listdir(self.root):
            if name.startswith("MANIFEST-"):
                try:
                    mx = max(mx, int(name.split("-")[1]))
                except ValueError:
                    pass
        return mx + 1

    def load(self) -> Optional[dict]:
        cur = os.path.join(self.root, "CURRENT")
        if not os.path.exists(cur):
            return None
        with open(cur) as f:
            name = f.read().strip()
        path = os.path.join(self.root, name)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def install(self, state: dict) -> None:
        name = f"MANIFEST-{self._next}"
        self._next += 1
        path = os.path.join(self.root, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, path)
        cur_tmp = os.path.join(self.root, "CURRENT.tmp")
        with open(cur_tmp, "w") as f:
            f.write(name)
            f.flush()
            os.fsync(f.fileno())
        os.rename(cur_tmp, os.path.join(self.root, "CURRENT"))
        # GC old manifests (keep last 3)
        manifests = sorted(
            (n for n in os.listdir(self.root) if n.startswith("MANIFEST-") and not n.endswith(".tmp")),
            key=lambda n: int(n.split("-")[1]),
        )
        for old in manifests[:-3]:
            try:
                os.remove(os.path.join(self.root, old))
            except OSError:
                pass
