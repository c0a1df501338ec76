"""Prefix-preserving key encoding (paper §3.2).

Token sequences are encoded as fixed-width big-endian ``uint32`` words so
that byte-lexicographic order over encoded keys coincides exactly with
token-prefix order:

  tokens_a is a prefix of tokens_b  <=>  encode(tokens_a) is a byte-prefix
                                         of encode(tokens_b)

and for any two sequences the lexicographic comparison of their encodings
equals the lexicographic comparison of the sequences themselves.  This is
the property the LSM index relies on: all cached blocks of one request sort
adjacently, so ``get_batch`` is a single range scan and compaction keeps
related prefixes physically clustered.

Keys can get long (a 32k-token prefix is 128 KiB); the SST block format
(``sst.py``) applies restart-point prefix compression, so consecutive keys
sharing a long token prefix cost only their suffix on disk.
"""

from __future__ import annotations

import struct
from typing import Sequence

import numpy as np

TOKEN_WIDTH = 4  # bytes per token word
_U32 = struct.Struct(">I")


def encode_tokens(tokens: Sequence[int]) -> bytes:
    """Encode a token-id sequence into an order-preserving byte key.

    Vectorized: key construction sits on the probe/scan hot path (a probe
    of an L-token prompt encodes O(log L) prefixes of up to L tokens), and
    the per-token ``struct.pack`` loop dominated read-side CPU profiles.
    """
    try:
        arr = np.asarray(tokens, dtype=">u4")
        # older numpy wraps out-of-range list ints silently: verify
        if arr.size and not np.array_equal(
            arr.astype(np.int64), np.asarray(tokens, dtype=np.int64)
        ):
            raise ValueError("token id out of range for key encoding")
    except (OverflowError, TypeError, ValueError) as e:
        raise ValueError(f"token id out of range for key encoding: {e}") from e
    if arr.ndim != 1:
        raise ValueError("token sequence must be one-dimensional")
    return arr.tobytes()


def decode_tokens(key: bytes) -> tuple:
    """Inverse of :func:`encode_tokens`."""
    if len(key) % TOKEN_WIDTH:
        raise ValueError(f"key length {len(key)} not a multiple of {TOKEN_WIDTH}")
    return tuple(_U32.unpack_from(key, i)[0] for i in range(0, len(key), TOKEN_WIDTH))


def key_token_len(key: bytes) -> int:
    return len(key) // TOKEN_WIDTH


def block_key(tokens: Sequence[int], block_size: int, block_idx: int) -> bytes:
    """Key for the ``block_idx``-th KV block: the whole prefix up to and
    including that block.  Using the *full* prefix (not just the block's own
    tokens) is what makes lookups content-addressed: two requests sharing a
    prefix produce identical keys regardless of what follows."""
    end = (block_idx + 1) * block_size
    if end > len(tokens):
        raise ValueError("block extends past token sequence")
    return encode_tokens(tokens[:end])


def shared_prefix_len(a: bytes, b: bytes) -> int:
    """Longest common byte prefix (for SST prefix compression)."""
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def successor(key: bytes):
    """Smallest key strictly greater than every key having ``key`` as a
    prefix (an exclusive range-scan upper bound).  Returns ``None`` when no
    finite successor exists (empty or all-0xFF keys): callers treat that as
    an unbounded scan."""
    b = bytearray(key)
    while b:
        if b[-1] != 0xFF:
            b[-1] += 1
            return bytes(b)
        b.pop()
    return None
