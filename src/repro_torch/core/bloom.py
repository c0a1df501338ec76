"""Bloom filter (Bloom 1970) used per sorted run to prune absent keys during
``probe`` point lookups (paper §2.2, App. B)."""

from __future__ import annotations

import hashlib
import math
import struct


def _hash2(key: bytes) -> tuple:
    d = hashlib.blake2b(key, digest_size=16).digest()
    return struct.unpack("<QQ", d)


class BloomFilter:
    __slots__ = ("nbits", "k", "bits")

    def __init__(self, nbits: int, k: int, bits: bytearray | None = None):
        self.nbits = max(8, nbits)
        self.k = max(1, k)
        self.bits = bits if bits is not None else bytearray((self.nbits + 7) // 8)

    @classmethod
    def for_entries(cls, n: int, bits_per_key: float = 10.0) -> "BloomFilter":
        n = max(1, n)
        nbits = int(n * bits_per_key)
        k = max(1, round(bits_per_key * math.log(2)))
        return cls(nbits, k)

    def add(self, key: bytes) -> None:
        h1, h2 = _hash2(key)
        for i in range(self.k):
            bit = (h1 + i * h2) % self.nbits
            self.bits[bit >> 3] |= 1 << (bit & 7)

    def __contains__(self, key: bytes) -> bool:
        h1, h2 = _hash2(key)
        for i in range(self.k):
            bit = (h1 + i * h2) % self.nbits
            if not (self.bits[bit >> 3] >> (bit & 7)) & 1:
                return False
        return True

    @property
    def false_positive_rate(self) -> float:
        """Analytic FPR given current fill (used by the cost model)."""
        ones = sum(bin(b).count("1") for b in self.bits)
        fill = ones / self.nbits
        return fill**self.k

    # -- serialization ------------------------------------------------------
    def to_bytes(self) -> bytes:
        return struct.pack("<II", self.nbits, self.k) + bytes(self.bits)

    @classmethod
    def from_bytes(cls, raw: bytes) -> "BloomFilter":
        nbits, k = struct.unpack_from("<II", raw)
        return cls(nbits, k, bytearray(raw[8:]))
