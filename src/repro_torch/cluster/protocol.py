"""Wire protocol of the cache cluster: length-prefixed, multiplexed
binary frames.

Many RPCs share one stream socket (TCP or ``AF_UNIX``) concurrently —
every frame carries a client-chosen request id, so responses may return
in any order and a streaming response interleaves with other traffic:

    frame    :=  u32 payload_len (big-endian) | payload
    payload  :=  u32 request_id | u8 kind | [u64 trace_id] | body
    kind     :=  0 REQUEST | 1 RESPONSE | 2 CHUNK | 3 END
                 (high bit FLAG_TRACE: an 8-byte trace id precedes body)

    REQUEST  body :=  u8 opcode | args
    RESPONSE body :=  u8 status | result     status 0 = ok, 1 = error
    CHUNK    body :=  u32 seq_index | u32 start_block | block list
    END      body :=  u8 status | u32 n | u32 served_counts[n]

Unary ops complete with a single RESPONSE.  The streaming gets
(``OP_GET_STREAM`` / ``OP_GET_MANY_STREAM``) emit zero or more CHUNK
frames followed by exactly one END summarizing blocks served per
sequence — the client starts consuming block 0 while later blocks are
still on the wire.

Bodies are flat ``struct``-packed binary — token sequences ride as the
same big-endian ``u32`` words the key codec uses on disk, tensor blocks
as ``dtype | shape | raw C-order bytes``, and the observability ops
(``STATS`` / ``MAINTENANCE``) as JSON, since their payloads are small
dicts.

Block lists are *packed* when homogeneous (the overwhelmingly common
case: every KV block of a sequence has the same dtype and shape): one
header plus a single contiguous raw region, so the receiver decodes a
whole batch with one ``frombuffer`` — a bulk, GIL-releasing operation —
instead of per-block Python work.  Decoded blocks are zero-copy views
into the receive buffer; per-response that buffer stays alive exactly as
long as its blocks do.  Heterogeneous lists fall back to a per-block
layout (layout byte 0).  This matters for scalability: the client is one
GIL domain fanning out to N nodes, and per-block decode bursts would
starve the very socket reads that keep those nodes busy.

A third layout (byte 2) carries *raw tensor-log records* — the exact
``u32 crc | u32 klen | u32 plen | key | payload`` bytes sitting on the
node's disk.  When the blocks of a chunk are one contiguous log extent,
the server ``os.sendfile``s them straight from the log file into the
socket — no read into Python, no re-encode — and the client CRC-checks
and ``BatchCodec.decode``s each record (the payload is self-describing),
paying the decode CPU it would have paid anyway while the node stays out
of the copy path entirely.

A fourth layout (byte 3) carries *encoded codec payloads* — length-
prefixed ``core.codec`` blobs exactly as stored, without the log-record
framing.  This is the buffered complement of the sendfile path: when a
backend exposes ``get_batch_encoded`` (the LSM stores do), the server
ships the still-compressed bytes and the client decodes, so an
int8+zlib cold tier moves ~3-4x fewer network bytes than decoded
blocks would, on every read path.  Block lists whose items are
bytes-like rather than ndarrays encode this way automatically.

Robustness contract (property-tested in ``tests/test_cluster.py``):

* ``encode``/``decode`` round-trip every op exactly;
* a frame longer than ``max_frame_bytes`` is rejected *before* the body
  is allocated (``FrameTooLarge``) — a malicious or corrupt length word
  cannot OOM a node;
* a connection that dies mid-frame raises ``TruncatedFrame`` — callers
  see a clean, retryable error, never a hang or a partial decode (socket
  timeouts bound the wait; ``recv_frame`` never spins on a dead peer);
* an orderly peer close *between* frames returns ``None`` (EOF), which
  is the normal end of a connection, not an error.

Every decoder bounds-checks against the actual payload length, so a
truncated or corrupted body surfaces as ``ProtocolError`` rather than an
out-of-range read.
"""

from __future__ import annotations

import json
import socket
import struct
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.codec import BatchCodec, CodecError

# Default cap on one frame.  A frame carries at most one batch of KV
# blocks; 256 MiB is ~64k blocks of 4 KiB — far beyond any batch the
# serving layer issues, and small enough that a corrupt length word is
# caught immediately.
MAX_FRAME_BYTES = 256 * 1024 * 1024

_U32 = struct.Struct(">I")
_U64 = struct.Struct(">Q")

# ------------------------------------------------------------------ opcodes
OP_PING = 1
OP_PROBE = 2
OP_PROBE_MANY = 3
OP_GET = 4
OP_GET_MANY = 5
OP_PUT = 6
OP_PUT_MANY = 7
OP_STATS = 8
OP_MAINTENANCE = 9
OP_FLUSH = 10
OP_GET_STREAM = 11
OP_GET_MANY_STREAM = 12
OP_METRICS = 13
# elasticity trio (cluster.migration): enumerate a node's keyspace in
# pages, pull stored records, push them to a new owner — blocks travel in
# their stored encoding (the unary cousin of LAYOUT_ENCODED), so cold
# tiers migrate compressed
OP_SCAN = 14
OP_PULL = 15
OP_PUSH = 16

OP_NAMES = {
    OP_PING: "ping",
    OP_PROBE: "probe",
    OP_PROBE_MANY: "probe_many",
    OP_GET: "get_batch",
    OP_GET_MANY: "get_many",
    OP_PUT: "put_batch",
    OP_PUT_MANY: "put_many",
    OP_STATS: "stats",
    OP_MAINTENANCE: "maintenance",
    OP_FLUSH: "flush",
    OP_GET_STREAM: "get_stream",
    OP_GET_MANY_STREAM: "get_many_stream",
    OP_METRICS: "metrics",
    OP_SCAN: "scan",
    OP_PULL: "pull",
    OP_PUSH: "push",
}

STREAM_OPS = (OP_GET_STREAM, OP_GET_MANY_STREAM)

STATUS_OK = 0
STATUS_ERROR = 1

# ------------------------------------------------------------- mux frames
KIND_REQUEST = 0
KIND_RESPONSE = 1
KIND_CHUNK = 2
KIND_END = 3

_MUX = struct.Struct(">IB")
MUX_HDR_BYTES = _MUX.size  # 5: u32 request_id | u8 kind

# Optional trace field: when the high bit of the kind byte is set, an
# 8-byte trace id follows the mux header before the body.  Old peers
# never set the flag, so the base frame layout is unchanged; REQUEST
# frames carry it client->server, the server never echoes it back.
FLAG_TRACE = 0x80
TRACE_ID_BYTES = 8


class ProtocolError(Exception):
    """Malformed frame or body — the connection is no longer trustworthy."""


class FrameTooLarge(ProtocolError):
    """Frame length exceeds the negotiated cap (rejected before allocation)."""


class TruncatedFrame(ProtocolError):
    """Peer died mid-frame (distinct from a clean between-frames EOF)."""


class RemoteError(Exception):
    """The node executed the request and reported a failure."""


# ----------------------------------------------------------------- framing
def pack_mux(request_id: int, kind: int, trace: Optional[bytes] = None) -> bytes:
    """Mux header; ``trace`` (exactly ``TRACE_ID_BYTES``) appends the
    optional trace-id field and sets ``FLAG_TRACE`` on the kind byte."""
    if trace is None:
        return _MUX.pack(request_id & 0xFFFFFFFF, kind)
    if len(trace) != TRACE_ID_BYTES:
        raise ProtocolError(f"trace id must be {TRACE_ID_BYTES} bytes, got {len(trace)}")
    return _MUX.pack(request_id & 0xFFFFFFFF, kind | FLAG_TRACE) + bytes(trace)


def split_mux_ex(payload) -> Tuple[int, int, Optional[bytes], memoryview]:
    """``(request_id, kind, trace_id_or_None, body)`` — body is a
    zero-copy view past the header and optional trace field."""
    if len(payload) < MUX_HDR_BYTES:
        raise ProtocolError(f"mux frame of {len(payload)} bytes has no header")
    rid, kind_raw = _MUX.unpack_from(payload)
    kind = kind_raw & ~FLAG_TRACE & 0xFF
    if kind > KIND_END:
        raise ProtocolError(f"unknown frame kind {kind}")
    off = MUX_HDR_BYTES
    trace = None
    if kind_raw & FLAG_TRACE:
        if len(payload) < off + TRACE_ID_BYTES:
            raise ProtocolError("frame flags a trace id but is too short to hold one")
        trace = bytes(memoryview(payload)[off : off + TRACE_ID_BYTES])
        off += TRACE_ID_BYTES
    return rid, kind, trace, memoryview(payload)[off:]


def split_mux(payload) -> Tuple[int, int, memoryview]:
    """``(request_id, kind, body)`` — body is a zero-copy view.  Any
    trace field is parsed and dropped; use :func:`split_mux_ex` to see it."""
    rid, kind, _trace, body = split_mux_ex(payload)
    return rid, kind, body


def send_frame(sock: socket.socket, payload: bytes) -> None:
    if len(payload) >= 1 << 16:
        # two sends spare a multi-MiB concat copy; small frames stay one
        sock.sendall(_U32.pack(len(payload)))
        sock.sendall(payload)
    else:
        sock.sendall(_U32.pack(len(payload)) + payload)


def send_frame_parts(sock: socket.socket, parts: Sequence) -> int:
    """Scatter-gather send of one frame built from ``parts`` (bytes or
    memoryview): the u32 length prefix is prepended and the whole vector
    handed to ``sendmsg``, so a multi-part frame (mux header + chunk
    header + tensor payload) goes out in one syscall with no concat
    copy.  Loops on partial sends.  Returns total bytes sent."""
    views = [memoryview(p).cast("B") for p in parts]
    total = sum(len(v) for v in views)
    views.insert(0, memoryview(_U32.pack(total)))
    sent_total = total + 4
    if not hasattr(sock, "sendmsg"):  # pragma: no cover — all POSIX targets have it
        sock.sendall(b"".join(views))
        return sent_total
    while views:
        sent = sock.sendmsg(views)
        while views and sent >= len(views[0]):
            sent -= len(views[0])
            views.pop(0)
        if sent and views:
            views[0] = views[0][sent:]
    return sent_total


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytearray]:
    """Read exactly ``n`` bytes into one preallocated buffer (no
    reassembly copy); ``None`` on immediate EOF, raises
    ``TruncatedFrame`` on EOF after a partial read."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], min(n - got, 1 << 20))
        if r == 0:
            if got == 0:
                return None
            raise TruncatedFrame(f"peer closed after {got}/{n} bytes")
        got += r
    return buf


def recv_frame(
    sock: socket.socket, max_frame_bytes: int = MAX_FRAME_BYTES
) -> Optional[bytes]:
    """Read one frame; ``None`` on clean EOF between frames."""
    header = _recv_exact(sock, 4)
    if header is None:
        return None
    (length,) = _U32.unpack(header)
    if length > max_frame_bytes:
        raise FrameTooLarge(f"frame of {length} bytes exceeds cap {max_frame_bytes}")
    if length == 0:
        return b""
    body = _recv_exact(sock, length)
    if body is None:
        raise TruncatedFrame("peer closed between frame header and body")
    return body


# ------------------------------------------------------------- primitives
class _Reader:
    """Bounds-checked cursor over a payload.  ``take`` returns zero-copy
    ``memoryview`` slices, so decoding a tensor batch never duplicates
    the receive buffer."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ProtocolError(
                f"body truncated: wanted {n} bytes at offset {self.pos}, "
                f"payload is {len(self.buf)}"
            )
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return _U32.unpack(self.take(4))[0]

    def u64(self) -> int:
        return _U64.unpack(self.take(8))[0]

    def done(self) -> None:
        if self.pos != len(self.buf):
            raise ProtocolError(f"{len(self.buf) - self.pos} trailing bytes after body")


def _enc_tokens(tokens: Sequence[int]) -> bytes:
    arr = np.asarray(tokens, dtype=">u4")
    if arr.ndim != 1:
        raise ProtocolError("token sequence must be one-dimensional")
    return _U32.pack(arr.size) + arr.tobytes()


def _dec_tokens(r: _Reader) -> List[int]:
    n = r.u32()
    return np.frombuffer(r.take(4 * n), dtype=">u4").astype(np.int64).tolist()


def _dtype_head(arr: np.ndarray) -> bytes:
    dt = arr.dtype.str.encode("ascii")  # e.g. b'<f2', endian-explicit
    head = struct.pack(">BB", len(dt), arr.ndim) + dt
    return head + b"".join(_U32.pack(d) for d in arr.shape)


def _dec_dtype_head(r: _Reader) -> Tuple[np.dtype, tuple]:
    dt_len, ndim = struct.unpack(">BB", r.take(2))
    try:
        dtype = np.dtype(bytes(r.take(dt_len)).decode("ascii"))
    except (TypeError, UnicodeDecodeError) as e:
        raise ProtocolError(f"bad block dtype: {e}") from e
    return dtype, tuple(r.u32() for _ in range(ndim))


def _block_nbytes(dtype: np.dtype, shape: tuple) -> int:
    return dtype.itemsize * int(np.prod(shape, dtype=np.int64)) if shape else dtype.itemsize


def _enc_block(block: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(block)
    return _dtype_head(arr) + _U64.pack(arr.nbytes) + arr.tobytes()


def _dec_block(r: _Reader) -> np.ndarray:
    dtype, shape = _dec_dtype_head(r)
    nbytes = r.u64()
    expect = _block_nbytes(dtype, shape)
    if nbytes != expect:
        raise ProtocolError(f"block byte count {nbytes} != dtype/shape product {expect}")
    raw = r.take(nbytes)
    return np.frombuffer(raw, dtype=dtype).reshape(shape)


def _enc_blocks(blocks: Sequence) -> List:
    """Encode a block list as parts for one final join.  Bytes-like items
    (still-encoded codec payloads from ``get_batch_encoded``) ride as
    layout 3 — the compressed bytes go over the wire verbatim.
    Homogeneous ndarray lists (layout 1, the common case for decoded
    blocks) pack every block into a single contiguous raw region; mixed
    lists (layout 0) ride per-block."""
    if blocks and all(isinstance(b, (bytes, bytearray, memoryview)) for b in blocks):
        parts: List = [_U32.pack(len(blocks)), b"\x03"]
        for p in blocks:
            parts.append(_U32.pack(len(p)))
            parts.append(p)
        return parts
    arrs = [np.ascontiguousarray(b) for b in blocks]
    if arrs and all(
        a.dtype == arrs[0].dtype and a.shape == arrs[0].shape for a in arrs[1:]
    ):
        packed = np.stack(arrs) if len(arrs) > 1 else arrs[0][None]
        return [
            _U32.pack(len(arrs)), b"\x01", _dtype_head(arrs[0]),
            _U64.pack(packed.nbytes), packed.data,
        ]
    return [_U32.pack(len(arrs)), b"\x00"] + [_enc_block(a) for a in arrs]


def _dec_encoded_blocks(r: _Reader, n: int) -> List[np.ndarray]:
    """Layout 3: length-prefixed self-describing codec payloads."""
    blocks: List[np.ndarray] = []
    for i in range(n):
        payload = r.take(r.u32())
        try:
            blocks.append(BatchCodec.decode(payload))
        except CodecError as e:
            raise ProtocolError(f"bad encoded block payload at block {i}: {e}") from e
    return blocks


def _dec_blocks(r: _Reader) -> List[np.ndarray]:
    n = r.u32()
    layout = r.u8()
    if layout == 0:
        return [_dec_block(r) for _ in range(n)]
    if layout == LAYOUT_ENCODED:
        return _dec_encoded_blocks(r, n)
    if layout != 1:
        raise ProtocolError(f"unknown block layout {layout}")
    dtype, shape = _dec_dtype_head(r)
    nbytes = r.u64()
    if nbytes != n * _block_nbytes(dtype, shape):
        raise ProtocolError(
            f"packed byte count {nbytes} != {n} x dtype/shape product"
        )
    raw = r.take(nbytes)
    arr = np.frombuffer(raw, dtype=dtype).reshape((n,) + shape)
    return list(arr)  # n zero-copy views over the receive buffer


# ------------------------------------------------------------- requests
def encode_request(op: int, *args) -> bytes:
    """Serialize one request.  Argument shapes per op:

    PING ()                           PROBE (tokens,)
    PROBE_MANY (seqs,)                GET (tokens, n_tokens)
    GET_MANY (items,)                 items = [(tokens, n_tokens), ...]
    PUT (tokens, blocks, start_block, skip_existing)
    PUT_MANY (items,)                 items = [(tokens, blocks, start), ...]
    STATS () / METRICS () / MAINTENANCE (compact_steps,) / FLUSH ()
    GET_STREAM (tokens, n_tokens, chunk_blocks)
    GET_MANY_STREAM (items, chunk_blocks)
    SCAN (cursor, limit, ranges)      cursor = bytes|None (opaque),
                                      ranges = [(lo, hi), ...] half-open
                                      wrapping ring arcs (u64) filtering
                                      by key hash; empty = whole keyspace
    PULL (keys,)                      keys = [bytes, ...]
    PUSH (records, skip_existing)     records = [(key, flags, payload), ...]
    """
    parts: List = [struct.pack(">B", op)]
    if op in (OP_PING, OP_STATS, OP_METRICS, OP_FLUSH):
        pass
    elif op == OP_PROBE:
        parts.append(_enc_tokens(args[0]))
    elif op == OP_PROBE_MANY:
        parts.append(_U32.pack(len(args[0])))
        parts.extend(_enc_tokens(t) for t in args[0])
    elif op == OP_GET:
        parts.append(_enc_tokens(args[0]) + _U64.pack(args[1]))
    elif op == OP_GET_MANY:
        parts.append(_U32.pack(len(args[0])))
        parts.extend(_enc_tokens(t) + _U64.pack(n) for t, n in args[0])
    elif op == OP_PUT:
        tokens, blocks, start_block, skip_existing = args
        parts.append(
            _enc_tokens(tokens)
            + _U32.pack(start_block)
            + struct.pack(">B", 1 if skip_existing else 0)
        )
        parts.extend(_enc_blocks(blocks))
    elif op == OP_PUT_MANY:
        parts.append(_U32.pack(len(args[0])))
        for t, bs, s in args[0]:
            parts.append(_enc_tokens(t) + _U32.pack(s))
            parts.extend(_enc_blocks(bs))
    elif op == OP_MAINTENANCE:
        parts.append(_U32.pack(args[0]))
    elif op == OP_GET_STREAM:
        parts.append(_enc_tokens(args[0]) + _U64.pack(args[1]) + _U32.pack(args[2]))
    elif op == OP_GET_MANY_STREAM:
        parts.append(_U32.pack(len(args[0])))
        parts.extend(_enc_tokens(t) + _U64.pack(n) for t, n in args[0])
        parts.append(_U32.pack(args[1]))
    elif op == OP_SCAN:
        cursor, limit, ranges = args
        if cursor is None:
            parts.append(b"\x00")
        else:
            parts.append(b"\x01" + _U32.pack(len(cursor)))
            parts.append(bytes(cursor))
        parts.append(_U32.pack(limit) + _U32.pack(len(ranges)))
        parts.extend(_U64.pack(lo) + _U64.pack(hi) for lo, hi in ranges)
    elif op == OP_PULL:
        parts.append(_U32.pack(len(args[0])))
        for k in args[0]:
            parts.append(_U32.pack(len(k)))
            parts.append(bytes(k))
    elif op == OP_PUSH:
        records, skip_existing = args
        parts.append(struct.pack(">B", 1 if skip_existing else 0))
        parts.append(_U32.pack(len(records)))
        for key, flags, payload in records:
            parts.append(_U32.pack(len(key)))
            parts.append(bytes(key))
            parts.append(struct.pack(">B", flags & 0xFF) + _U32.pack(len(payload)))
            parts.append(payload)
    else:
        raise ProtocolError(f"unknown opcode {op}")
    return b"".join(parts)


def decode_request(payload: bytes) -> Tuple[int, tuple]:
    """Inverse of :func:`encode_request`: ``(op, args)``."""
    if not payload:
        raise ProtocolError("empty request payload")
    r = _Reader(payload)
    op = r.u8()
    if op in (OP_PING, OP_STATS, OP_METRICS, OP_FLUSH):
        args: tuple = ()
    elif op == OP_PROBE:
        args = (_dec_tokens(r),)
    elif op == OP_PROBE_MANY:
        args = ([_dec_tokens(r) for _ in range(r.u32())],)
    elif op == OP_GET:
        args = (_dec_tokens(r), r.u64())
    elif op == OP_GET_MANY:
        args = ([(_dec_tokens(r), r.u64()) for _ in range(r.u32())],)
    elif op == OP_PUT:
        tokens = _dec_tokens(r)
        start_block = r.u32()
        skip_existing = bool(r.u8())
        args = (tokens, _dec_blocks(r), start_block, skip_existing)
    elif op == OP_PUT_MANY:
        n = r.u32()
        items = []
        for _ in range(n):
            tokens = _dec_tokens(r)
            start = r.u32()
            items.append((tokens, _dec_blocks(r), start))
        args = (items,)
    elif op == OP_MAINTENANCE:
        args = (r.u32(),)
    elif op == OP_GET_STREAM:
        args = (_dec_tokens(r), r.u64(), r.u32())
    elif op == OP_GET_MANY_STREAM:
        items = [(_dec_tokens(r), r.u64()) for _ in range(r.u32())]
        args = (items, r.u32())
    elif op == OP_SCAN:
        cursor = bytes(r.take(r.u32())) if r.u8() else None
        limit = r.u32()
        ranges = [(r.u64(), r.u64()) for _ in range(r.u32())]
        args = (cursor, limit, ranges)
    elif op == OP_PULL:
        args = ([bytes(r.take(r.u32())) for _ in range(r.u32())],)
    elif op == OP_PUSH:
        skip_existing = bool(r.u8())
        records = []
        for _ in range(r.u32()):
            key = bytes(r.take(r.u32()))
            flags = r.u8()
            records.append((key, flags, bytes(r.take(r.u32()))))
        args = (records, skip_existing)
    else:
        raise ProtocolError(f"unknown opcode {op}")
    r.done()
    return op, args


# ------------------------------------------------------------- responses
def encode_ok(op: int, result) -> bytes:
    """Serialize a success response for ``op``."""
    parts: List = [struct.pack(">B", STATUS_OK)]
    if op in (OP_PING, OP_FLUSH):
        pass
    elif op in (OP_PROBE, OP_PUT):
        parts.append(_U64.pack(int(result)))
    elif op in (OP_PROBE_MANY, OP_PUT_MANY):
        parts.append(_U32.pack(len(result)))
        parts.extend(_U64.pack(int(v)) for v in result)
    elif op == OP_GET:
        parts.extend(_enc_blocks(result))
    elif op == OP_GET_MANY:
        parts.append(_U32.pack(len(result)))
        for bs in result:
            parts.extend(_enc_blocks(bs))
    elif op in (OP_STATS, OP_METRICS, OP_MAINTENANCE):
        parts.append(json.dumps(result).encode("utf-8"))
    elif op == OP_SCAN:
        keys, next_cursor = result
        if next_cursor is None:
            parts.append(b"\x00")
        else:
            parts.append(b"\x01" + _U32.pack(len(next_cursor)))
            parts.append(bytes(next_cursor))
        parts.append(_U32.pack(len(keys)))
        for k in keys:
            parts.append(_U32.pack(len(k)))
            parts.append(bytes(k))
    elif op == OP_PULL:
        parts.append(_U32.pack(len(result)))
        for rec in result:
            if rec is None:
                parts.append(b"\x00")
            else:
                flags, payload = rec
                parts.append(b"\x01" + struct.pack(">B", flags & 0xFF) + _U32.pack(len(payload)))
                parts.append(payload)
    elif op == OP_PUSH:
        parts.append(_U64.pack(int(result)))
    else:
        raise ProtocolError(f"unknown opcode {op}")
    return b"".join(parts)


def encode_error(message: str) -> bytes:
    return struct.pack(">B", STATUS_ERROR) + message.encode("utf-8", "replace")


def decode_response(op: int, payload: bytes):
    """Decode a response to a request of type ``op``; raises
    ``RemoteError`` if the node reported a failure."""
    if not payload:
        raise ProtocolError("empty response payload")
    r = _Reader(payload)
    status = r.u8()
    if status == STATUS_ERROR:
        raise RemoteError(bytes(r.buf[r.pos :]).decode("utf-8", "replace"))
    if status != STATUS_OK:
        raise ProtocolError(f"unknown response status {status}")
    if op in (OP_PING, OP_FLUSH):
        result = None
    elif op in (OP_PROBE, OP_PUT):
        result = r.u64()
    elif op in (OP_PROBE_MANY, OP_PUT_MANY):
        result = [r.u64() for _ in range(r.u32())]
    elif op == OP_GET:
        result = _dec_blocks(r)
    elif op == OP_GET_MANY:
        result = [_dec_blocks(r) for _ in range(r.u32())]
    elif op in (OP_STATS, OP_METRICS, OP_MAINTENANCE):
        try:
            return json.loads(bytes(r.buf[r.pos :]).decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ProtocolError(f"bad JSON response body: {e}") from e
    elif op == OP_SCAN:
        next_cursor = bytes(r.take(r.u32())) if r.u8() else None
        keys = [bytes(r.take(r.u32())) for _ in range(r.u32())]
        result = (keys, next_cursor)
    elif op == OP_PULL:
        recs: List[Optional[Tuple[int, bytes]]] = []
        for _ in range(r.u32()):
            if r.u8():
                flags = r.u8()
                recs.append((flags, bytes(r.take(r.u32()))))
            else:
                recs.append(None)
        result = recs
    elif op == OP_PUSH:
        result = r.u64()
    else:
        raise ProtocolError(f"unknown opcode {op}")
    r.done()
    return result


# ------------------------------------------------------------ stream chunks
# chunk body := u32 seq_index | u32 start_block | u32 n | u8 layout | ...
# layouts 0/1 are the block-list layouts above; layout 2 is raw tensor-log
# records (server sendfile path, client-side CRC + BatchCodec decode);
# layout 3 is length-prefixed encoded codec payloads (buffered compressed
# path, client-side BatchCodec decode).
LAYOUT_VLOG = 2
LAYOUT_ENCODED = 3
_VLOG_HDR = struct.Struct("<III")  # crc | klen | plen — the on-disk record header


def encode_stream_chunk(seq_index: int, start_block: int, blocks: Sequence[np.ndarray]) -> List:
    """Encode one decoded-blocks chunk as parts for ``send_frame_parts``."""
    return [_U32.pack(seq_index), _U32.pack(start_block)] + _enc_blocks(blocks)


def encode_vlog_chunk_header(seq_index: int, start_block: int, n_records: int, nbytes: int) -> bytes:
    """Header of a layout-2 chunk; the ``nbytes`` of raw log records that
    follow are shipped by ``os.sendfile`` straight from the log file."""
    return (
        _U32.pack(seq_index) + _U32.pack(start_block)
        + _U32.pack(n_records) + b"\x02" + _U64.pack(nbytes)
    )


def _dec_vlog_records(r: _Reader, n: int) -> List[np.ndarray]:
    nbytes = r.u64()
    raw = r.take(nbytes)
    blocks: List[np.ndarray] = []
    pos = 0
    for _ in range(n):
        if pos + _VLOG_HDR.size > nbytes:
            raise ProtocolError(f"vlog chunk truncated at record {len(blocks)}")
        crc, klen, plen = _VLOG_HDR.unpack_from(raw, pos)
        body = raw[pos + _VLOG_HDR.size : pos + _VLOG_HDR.size + klen + plen]
        if len(body) != klen + plen:
            raise ProtocolError(f"vlog chunk truncated at record {len(blocks)}")
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            raise ProtocolError(f"vlog record CRC mismatch at record {len(blocks)}")
        try:
            blocks.append(BatchCodec.decode(body[klen:]))
        except (struct.error, KeyError, ValueError, zlib.error) as e:
            raise ProtocolError(f"bad vlog record payload: {e}") from e
        pos += _VLOG_HDR.size + klen + plen
    if pos != nbytes:
        raise ProtocolError(f"{nbytes - pos} trailing bytes after vlog records")
    return blocks


def decode_stream_chunk(body) -> Tuple[int, int, List[np.ndarray]]:
    """``(seq_index, start_block, blocks)`` from one CHUNK body."""
    r = _Reader(body)
    seq_index = r.u32()
    start_block = r.u32()
    n = r.u32()
    layout = r.u8()
    if layout == LAYOUT_VLOG:
        blocks = _dec_vlog_records(r, n)
    elif layout == LAYOUT_ENCODED:
        blocks = _dec_encoded_blocks(r, n)
    elif layout == 0:
        blocks = [_dec_block(r) for _ in range(n)]
    elif layout == 1:
        dtype, shape = _dec_dtype_head(r)
        nbytes = r.u64()
        if nbytes != n * _block_nbytes(dtype, shape):
            raise ProtocolError(f"packed byte count {nbytes} != {n} x dtype/shape product")
        raw = r.take(nbytes)
        blocks = list(np.frombuffer(raw, dtype=dtype).reshape((n,) + shape))
    else:
        raise ProtocolError(f"unknown block layout {layout}")
    r.done()
    return seq_index, start_block, blocks


def encode_stream_end(counts: Sequence[int]) -> bytes:
    """END frame body: per-sequence blocks-served totals (the client
    verifies its assembled streams against these)."""
    return (
        struct.pack(">B", STATUS_OK)
        + _U32.pack(len(counts))
        + b"".join(_U32.pack(int(c)) for c in counts)
    )


def decode_stream_end(body) -> List[int]:
    """Served-count list from an END body; raises ``RemoteError`` if the
    node aborted the stream with an application failure."""
    r = _Reader(body)
    status = r.u8()
    if status == STATUS_ERROR:
        raise RemoteError(bytes(r.buf[r.pos :]).decode("utf-8", "replace"))
    if status != STATUS_OK:
        raise ProtocolError(f"unknown stream end status {status}")
    counts = [r.u32() for _ in range(r.u32())]
    r.done()
    return counts
