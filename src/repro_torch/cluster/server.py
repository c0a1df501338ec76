"""``CacheNodeServer`` — one cache node: a socket front-end over any
thread-safe ``StorageBackend``.

The server is a thin RPC shim, deliberately: every byte of storage logic
stays in the backend (which already carries the ``core/backend.py``
thread-safety contract), so a node is "an existing store, served".

Architecture (one node):

    acceptor/selector thread          IOExecutor (N workers)
    ─────────────────────────────────────────────────────────
    accept, read socket bytes,   ──►  decode request
    reassemble frames,                run the backend op
    submit each to the pool           send tagged response frame(s)
    (non-blocking, all conns)         (per-connection write lock)

Connections are **pipelined**: every complete frame is handed to the
executor as it arrives, so one connection can have many requests in
flight and responses return in completion order, tagged with the request
id the client chose — this is the server half of the multiplexed
protocol.  Writes from concurrent workers serialize on a per-connection
lock; frames never interleave.  When all workers are busy the selector
thread blocks on pool admission, which backpressures every client
instead of queueing unboundedly.

Streaming gets (``OP_GET_STREAM`` / ``OP_GET_MANY_STREAM``) emit CHUNK
frames as blocks become available and an END frame with per-sequence
totals.  Two send paths:

* **scatter-gather** — decoded blocks go out with one ``sendmsg`` per
  chunk (mux header + chunk header + packed tensor region), no concat
  copy;
* **zero-copy** — when the backend can hand the chunk as a contiguous
  tensor-log extent (``get_batch_raw``), the records are pushed with
  ``os.sendfile`` straight from the log file to the socket: the payload
  bytes never enter Python, and the node's CPU stays out of the read
  path entirely (the client decodes — it was going to pay that CPU
  anyway).  The open file descriptor pins the inode, so eviction
  unlinking the file mid-send is harmless.

Transports: TCP (``host``/``port``) or ``AF_UNIX`` (``unix_path``) — the
frame protocol is transport-agnostic (``os.sendfile`` works on both).
"""

from __future__ import annotations

import errno
import os
import select
import selectors
import socket
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional, Tuple, Union

from ..core.store import StoreStats
from ..obs import MetricsRegistry, dataclass_gauges
from ..runtime.executor import IOExecutor
from . import protocol as P
from .ring import in_arc, raw_key_hash

Address = Union[Tuple[str, int], str]  # (host, port) or unix socket path

_DONTWAIT = getattr(socket, "MSG_DONTWAIT", 0)
# errnos that mean "sendfile cannot work here at all" (vs. a dead peer):
# flip to the copying path instead of erroring every stream.
_SENDFILE_UNSUPPORTED = {errno.EINVAL, errno.ENOSYS, errno.EOPNOTSUPP, errno.ENOTSOCK}


@dataclass
class ServerStats:
    connections_accepted: int = 0
    connections_open: int = 0
    requests: int = 0
    errors: int = 0  # backend/op failures reported to the client
    protocol_errors: int = 0  # malformed frames (connection dropped)
    bytes_in: int = 0
    bytes_out: int = 0
    streams: int = 0
    stream_chunks: int = 0
    stream_blocks: int = 0
    raw_extents: int = 0  # chunks served straight from the tensor log
    sendfile_bytes: int = 0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class _Conn:
    __slots__ = ("sock", "buf", "alive", "wlock")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.buf = bytearray()
        self.alive = True
        self.wlock = threading.Lock()  # concurrent workers; frames never interleave


class CacheNodeServer:
    def __init__(
        self,
        backend,
        host: str = "127.0.0.1",
        port: int = 0,
        unix_path: Optional[str] = None,
        io_threads: int = 2,
        io_executor: Optional[IOExecutor] = None,
        max_frame_bytes: int = P.MAX_FRAME_BYTES,
        send_timeout_s: float = 30.0,
        zero_copy: bool = True,
        max_chunk_blocks: int = 1024,
        registry: Optional[MetricsRegistry] = None,
    ):
        """``send_timeout_s`` bounds response writes: a client that stops
        reading (stalled, hostile) gets dropped instead of wedging an
        executor worker forever — with a small pool, unbounded sends
        would eventually wedge every worker and stop the whole node.
        ``zero_copy=False`` disables the sendfile path (every chunk is
        read + decoded + re-encoded host-side, for A/B measurement)."""
        self.backend = backend
        self.max_frame_bytes = max_frame_bytes
        self.send_timeout_s = send_timeout_s
        self.max_chunk_blocks = max(1, int(max_chunk_blocks))
        self.zero_copy = bool(zero_copy) and hasattr(os, "sendfile")
        self.stats = ServerStats()
        self._stats_lock = threading.Lock()
        # ---- observability: one registry per node, scraped via OP_METRICS
        # (or the --metrics-port HTTP endpoint).  Server/backend stats are
        # bridged in as collectors; request latencies land in histograms.
        self.registry = registry or MetricsRegistry()
        self.registry.register_collector(
            dataclass_gauges("repro_server", self.stats, lock=self._stats_lock))
        self.registry.register_collector(self._backend_gauges)
        self._h_request = self.registry.histogram(
            "repro_node_request_seconds", "server-side latency of every request")
        self._h_trace_span = self.registry.histogram(
            "repro_node_trace_server_span_seconds",
            "server-side span of requests that carried a trace id")
        self._c_trace_requests = self.registry.counter(
            "repro_node_trace_requests_total", "requests that carried a trace id")
        self._recent_traces: deque = deque(maxlen=16)  # hex ids, newest last
        if io_executor is not None:
            self._executor, self._owns_executor = io_executor, False
        else:
            # handlers are short (one request), so pending-job admission can
            # be generous: stalls mean every worker is mid-request already.
            # io_threads is the node's *serving width* — these workers block
            # on disk reads and sendall/sendfile with the GIL released, so
            # the width must not be silently clamped to the core count (a
            # 1-core host still wants 2 in-flight requests so a slow get
            # cannot head-of-line block the connection)
            self._executor = IOExecutor(
                max_workers=max(1, io_threads), max_pending=64, cap_to_cpu=False
            )
            self._owns_executor = True
        if unix_path is not None:
            self._listener = socket.socket(socket.AF_UNIX)
            if os.path.exists(unix_path):
                os.unlink(unix_path)
            self._listener.bind(unix_path)
            self.address: Address = unix_path
        else:
            self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._listener.bind((host, port))
            self.address = self._listener.getsockname()
        self._listener.listen(128)
        self._listener.setblocking(False)
        self._selector = selectors.DefaultSelector()
        self._selector.register(self._listener, selectors.EVENT_READ, "accept")
        # self-pipe so close() can wake the selector promptly
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._selector.register(self._wake_r, selectors.EVENT_READ, "wake")
        self._conns: set = set()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="cache-node", daemon=True)

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "CacheNodeServer":
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        self._wake()
        self._thread.join(timeout=10)
        for conn in list(self._conns):
            self._drop(conn, unregister=False)
        try:
            self._selector.close()
        except OSError:
            pass
        self._listener.close()
        self._wake_r.close()
        self._wake_w.close()
        if isinstance(self.address, str) and os.path.exists(self.address):
            os.unlink(self.address)
        if self._owns_executor:
            self._executor.close()

    def __enter__(self) -> "CacheNodeServer":
        return self.start() if not self._thread.is_alive() else self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ selector
    def _wake(self) -> None:
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    def _loop(self) -> None:
        while not self._stop.is_set():
            events = self._selector.select(timeout=0.5)
            for key, _ in events:
                if key.data == "accept":
                    self._accept()
                elif key.data == "wake":
                    try:
                        self._wake_r.recv(4096)
                    except OSError:
                        pass
                else:
                    self._read(key.data)

    def _accept(self) -> None:
        while True:
            try:
                sock, _ = self._listener.accept()
            except (BlockingIOError, OSError):
                return
            # timeout mode: reads happen when the selector says readable;
            # writes (from executor workers) block at most send_timeout_s
            sock.settimeout(self.send_timeout_s)
            conn = _Conn(sock)
            self._conns.add(conn)
            with self._stats_lock:
                self.stats.connections_accepted += 1
                self.stats.connections_open += 1
            self._selector.register(sock, selectors.EVENT_READ, conn)

    def _read(self, conn: _Conn) -> None:
        try:
            chunk = conn.sock.recv(1 << 20, _DONTWAIT)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._drop(conn)
            return
        if not chunk:
            self._drop(conn)
            return
        conn.buf += chunk
        with self._stats_lock:
            self.stats.bytes_in += len(chunk)
        self._pump(conn)

    def _pump(self, conn: _Conn) -> None:
        """Hand every complete buffered frame to the executor — requests
        on one connection are pipelined, not one-at-a-time."""
        while conn.alive and len(conn.buf) >= 4:
            length = int.from_bytes(conn.buf[:4], "big")
            if length > self.max_frame_bytes:
                # reject before allocating/reading the body: a corrupt
                # length word must not OOM the node or desync the stream
                with self._stats_lock:
                    self.stats.protocol_errors += 1
                # tag the error with the claimed rid if its bytes arrived
                rid = int.from_bytes(conn.buf[4:8], "big") if len(conn.buf) >= 8 else 0
                self._send_best_effort(
                    conn, rid, P.encode_error(f"frame of {length} bytes exceeds cap")
                )
                self._drop(conn)
                return
            if len(conn.buf) < 4 + length:
                return
            payload = bytes(conn.buf[4 : 4 + length])
            del conn.buf[: 4 + length]
            try:
                rid, kind, trace, body = P.split_mux_ex(payload)
            except P.ProtocolError:
                with self._stats_lock:
                    self.stats.protocol_errors += 1
                self._send_best_effort(conn, 0, P.encode_error("malformed mux frame"))
                self._drop(conn)
                return
            if kind != P.KIND_REQUEST:
                with self._stats_lock:
                    self.stats.protocol_errors += 1
                self._send_best_effort(
                    conn, rid, P.encode_error(f"unexpected frame kind {kind}")
                )
                self._drop(conn)
                return
            self._executor.submit(self._handle, conn, rid, bytes(body), trace)

    def _drop(self, conn: _Conn, unregister: bool = True) -> None:
        if not conn.alive:
            return
        conn.alive = False
        if unregister:
            try:
                self._selector.unregister(conn.sock)
            except (KeyError, ValueError, OSError):
                pass
        try:
            conn.sock.close()
        except OSError:
            pass
        self._conns.discard(conn)
        with self._stats_lock:
            self.stats.connections_open -= 1

    # ------------------------------------------------------------- sending
    def _send(self, conn: _Conn, rid: int, kind: int, parts) -> int:
        """One tagged frame, under the connection's write lock.  OSError
        (including the bounded-send timeout) propagates to the caller,
        which drops the connection."""
        with conn.wlock:
            n = P.send_frame_parts(conn.sock, [P.pack_mux(rid, kind)] + list(parts))
        with self._stats_lock:
            self.stats.bytes_out += n
        return n

    def _send_best_effort(self, conn: _Conn, rid: int, payload: bytes) -> None:
        try:
            self._send(conn, rid, P.KIND_RESPONSE, [payload])
        except OSError:
            pass

    # ------------------------------------------------------------ handling
    def _handle(self, conn: _Conn, rid: int, request: bytes,
                trace: Optional[bytes] = None) -> None:
        """Executor worker: decode, run the backend op, respond.  The
        op's wall time lands in the request/per-op histograms; if the
        frame carried a trace id, the same interval closes the trace out
        server-side (span histogram + recent-traces ring)."""
        t0 = time.perf_counter()
        try:
            op, args = P.decode_request(request)
        except P.ProtocolError as e:
            with self._stats_lock:
                self.stats.protocol_errors += 1
            self._send_best_effort(conn, rid, P.encode_error(f"protocol error: {e}"))
            self._drop(conn)
            return
        if op in P.STREAM_OPS:
            self._handle_stream(conn, rid, op, args, trace=trace, t0=t0)
            return
        try:
            result = self._dispatch(op, args)
            payload = P.encode_ok(op, result)
        except Exception as e:  # noqa: BLE001 — reported to the client
            with self._stats_lock:
                self.stats.errors += 1
            payload = P.encode_error(f"{type(e).__name__}: {e}")
        with self._stats_lock:
            self.stats.requests += 1
        self._observe_op(op, time.perf_counter() - t0, trace)
        try:
            self._send(conn, rid, P.KIND_RESPONSE, [payload])
        except OSError:
            self._drop(conn)

    def _observe_op(self, op: int, elapsed_s: float, trace: Optional[bytes]) -> None:
        self._h_request.observe(elapsed_s)
        self.registry.histogram(
            f"repro_node_op_seconds_{P.OP_NAMES.get(op, op)}").observe(elapsed_s)
        if trace is not None:
            self._c_trace_requests.inc()
            self._h_trace_span.observe(elapsed_s)
            self._recent_traces.append(trace.hex())

    # ----------------------------------------------------------- streaming
    def _handle_stream(self, conn: _Conn, rid: int, op: int, args: tuple,
                       trace: Optional[bytes] = None,
                       t0: Optional[float] = None) -> None:
        if t0 is None:
            t0 = time.perf_counter()
        if op == P.OP_GET_STREAM:
            tokens, n_tokens, chunk_blocks = args
            items = [(tokens, n_tokens)]
        else:
            items, chunk_blocks = args
        chunk_blocks = max(1, min(int(chunk_blocks), self.max_chunk_blocks))
        with self._stats_lock:
            self.stats.requests += 1
            self.stats.streams += 1
        counts = []
        try:
            for seq_index, (tokens, n_tokens) in enumerate(items):
                counts.append(
                    self._stream_item(conn, rid, seq_index, tokens, n_tokens, chunk_blocks)
                )
        except OSError:
            self._drop(conn)
            return
        except Exception as e:  # noqa: BLE001 — abort the stream, report
            with self._stats_lock:
                self.stats.errors += 1
            self._observe_op(op, time.perf_counter() - t0, trace)
            try:
                self._send(conn, rid, P.KIND_END, [P.encode_error(f"{type(e).__name__}: {e}")])
            except OSError:
                self._drop(conn)
            return
        self._observe_op(op, time.perf_counter() - t0, trace)
        try:
            self._send(conn, rid, P.KIND_END, [P.encode_stream_end(counts)])
        except OSError:
            self._drop(conn)

    def _stream_item(
        self, conn: _Conn, rid: int, seq_index: int, tokens, n_tokens: int, chunk_blocks: int
    ) -> int:
        """Stream one sequence's blocks as CHUNK frames; returns blocks
        served.  Prefers the zero-copy extent path, falls back to the
        decoded path (which re-encodes over the wire format)."""
        if self.zero_copy:
            raw_fn = getattr(self.backend, "get_batch_raw", None)
            if raw_fn is not None:
                rb = raw_fn(tokens, n_tokens)
                if rb is not None:
                    try:
                        return self._stream_raw(conn, rid, seq_index, rb, chunk_blocks)
                    finally:
                        rb.close()
        # buffered fallback: ship still-encoded payloads (layout 3) when
        # the backend can hand them out — the compressed-bytes complement
        # of the sendfile path, so even non-extent reads keep the wire
        # compressed.  Backends without the method send decoded blocks.
        enc_fn = getattr(self.backend, "get_batch_encoded", None)
        blocks = (enc_fn or self.backend.get_batch)(tokens, n_tokens)
        for start in range(0, len(blocks), chunk_blocks):
            part = blocks[start : start + chunk_blocks]
            self._send(
                conn, rid, P.KIND_CHUNK, P.encode_stream_chunk(seq_index, start, part)
            )
            with self._stats_lock:
                self.stats.stream_chunks += 1
                self.stats.stream_blocks += len(part)
        return len(blocks)

    def _stream_raw(self, conn: _Conn, rid: int, seq_index: int, rb, chunk_blocks: int) -> int:
        """Zero-copy chunk emission: frame headers via ``sendmsg``, then
        ``os.sendfile`` pushes the raw log records kernel-to-kernel."""
        in_fd = rb.file.fileno()
        offset = rb.offset
        i = 0
        while i < rb.n_blocks:
            lens = rb.record_lengths[i : i + chunk_blocks]
            nbytes = sum(lens)
            hdr = P.encode_vlog_chunk_header(seq_index, i, len(lens), nbytes)
            mux = P.pack_mux(rid, P.KIND_CHUNK)
            frame_len = len(mux) + len(hdr) + nbytes
            with conn.wlock:
                conn.sock.sendall(
                    frame_len.to_bytes(4, "big") + mux + hdr
                )
                self._sendfile(conn.sock, in_fd, offset, nbytes)
            with self._stats_lock:
                self.stats.bytes_out += 4 + frame_len
                self.stats.stream_chunks += 1
                self.stats.stream_blocks += len(lens)
                self.stats.raw_extents += 1
                self.stats.sendfile_bytes += nbytes
            offset += nbytes
            i += len(lens)
        return rb.n_blocks

    def _sendfile(self, sock: socket.socket, in_fd: int, offset: int, nbytes: int) -> None:
        """``os.sendfile`` with the same bounded-send discipline as
        ``sendall``: the socket fd is non-blocking (timeout mode), so
        loop on EAGAIN with a writability wait and an overall deadline."""
        out_fd = sock.fileno()
        sent = 0
        deadline = time.monotonic() + self.send_timeout_s
        while sent < nbytes:
            try:
                n = os.sendfile(out_fd, in_fd, offset + sent, nbytes - sent)
            except (BlockingIOError, InterruptedError):
                n = 0
            except OSError as e:
                if e.errno in _SENDFILE_UNSUPPORTED and sent == 0 and self.zero_copy:
                    # environment can't sendfile at all: fall back to a
                    # plain copy of the records (frame header already out,
                    # so the byte stream must be completed either way)
                    self.zero_copy = False
                    self._copy_file_range(sock, in_fd, offset, nbytes, deadline)
                    return
                raise
            if n == 0:
                if time.monotonic() > deadline:
                    raise socket.timeout(f"sendfile stalled after {sent}/{nbytes} bytes")
                select.select([], [out_fd], [], 0.2)
                continue
            sent += n

    def _copy_file_range(
        self, sock: socket.socket, in_fd: int, offset: int, nbytes: int, deadline: float
    ) -> None:
        remaining = nbytes
        pos = offset
        while remaining:
            if time.monotonic() > deadline:
                raise socket.timeout("stream send stalled")
            data = os.pread(in_fd, min(remaining, 1 << 20), pos)
            if not data:
                raise OSError(f"log file truncated {remaining} bytes short")
            sock.sendall(data)
            pos += len(data)
            remaining -= len(data)

    # ------------------------------------------------------------ dispatch
    def _dispatch(self, op: int, args: tuple):
        b = self.backend
        if op == P.OP_PING:
            return None
        if op == P.OP_PROBE:
            return b.probe(args[0])
        if op == P.OP_PROBE_MANY:
            return b.probe_many(args[0])
        if op == P.OP_GET:
            # prefer still-encoded payloads (layout 3): the wire carries
            # the compressed bytes the disk stores; the client decodes
            enc = getattr(b, "get_batch_encoded", None)
            if enc is not None:
                return enc(args[0], args[1])
            return b.get_batch(args[0], args[1])
        if op == P.OP_GET_MANY:
            enc = getattr(b, "get_batch_encoded", None)
            if enc is not None:
                return [enc(tokens, n) for tokens, n in args[0]]
            return b.get_many(args[0])
        if op == P.OP_PUT:
            tokens, blocks, start_block, skip_existing = args
            return b.put_batch(tokens, blocks, start_block=start_block,
                               skip_existing=skip_existing)
        if op == P.OP_PUT_MANY:
            return b.put_many(args[0])
        if op == P.OP_STATS:
            st = b.stats
            fields = {
                k: v for k, v in st.__dict__.items()
                if isinstance(v, (int, float))
            } if not isinstance(st, StoreStats) else dict(st.__dict__)
            return {
                "name": getattr(b, "name", "?"),
                "block_size": b.block_size,
                "disk_bytes": b.disk_bytes,
                "file_count": b.file_count,
                "stats": fields,
                "server": self.stats.as_dict(),
            }
        if op == P.OP_METRICS:
            return self.metrics_report()
        if op == P.OP_MAINTENANCE:
            return b.maintenance(args[0])
        if op == P.OP_FLUSH:
            b.flush()
            return None
        # elasticity trio (cluster.migration) — optional backend methods,
        # duck-typed like get_batch_encoded.  The ring-arc filter runs
        # here, not in the backend: core stays placement-agnostic, and
        # the hash is recomputed from the key bytes (raw_key_hash), so a
        # node needs no token decode to place its own data.
        if op == P.OP_SCAN:
            cursor, limit, ranges = args
            fn = getattr(b, "scan_keys", None)
            if fn is None:
                raise RuntimeError(
                    f"backend {getattr(b, 'name', '?')} does not support key scans")
            keys, next_cursor = fn(cursor, limit)
            if ranges:
                keys = [
                    k for k in keys
                    if any(in_arc(lo, hi, raw_key_hash(k, b.block_size))
                           for lo, hi in ranges)
                ]
            return keys, next_cursor
        if op == P.OP_PULL:
            fn = getattr(b, "export_encoded", None)
            if fn is None:
                raise RuntimeError(
                    f"backend {getattr(b, 'name', '?')} does not support block export")
            return fn(args[0])
        if op == P.OP_PUSH:
            records, skip_existing = args
            fn = getattr(b, "import_encoded", None)
            if fn is None:
                raise RuntimeError(
                    f"backend {getattr(b, 'name', '?')} does not support block import")
            return fn(records, skip_existing=skip_existing)
        raise P.ProtocolError(f"unknown opcode {op}")

    # ------------------------------------------------------- observability
    def _backend_gauges(self) -> dict:
        """Collector: backend store + LSM stats as ``repro_store_*`` /
        ``repro_lsm_*`` gauges (summed across shards for sharded
        backends), plus disk usage.  Tolerant of minimal backends."""
        b = self.backend
        out: dict = {}
        st = getattr(b, "stats", None)
        if st is not None:
            for k, v in vars(st).items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    out[f"repro_store_{k}"] = float(v)
        for attr, name in (("disk_bytes", "repro_node_disk_bytes"),
                           ("file_count", "repro_node_file_count")):
            try:
                v = getattr(b, attr, None)
            except OSError:
                v = None
            if isinstance(v, (int, float)):
                out[name] = float(v)
        stores = getattr(b, "shards", None) or [b]
        lsm: dict = {}
        for s in stores:
            idx = getattr(s, "index", None)
            lst = getattr(idx, "stats", None)
            if lst is None:
                continue
            for k, v in vars(lst).items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    lsm[f"repro_lsm_{k}"] = lsm.get(f"repro_lsm_{k}", 0.0) + float(v)
        out.update(lsm)
        return out

    def metrics_report(self) -> dict:
        """Full registry snapshot plus node identity and the most recent
        trace ids this node closed out — the ``OP_METRICS`` body."""
        return {
            "name": getattr(self.backend, "name", "?"),
            "block_size": getattr(self.backend, "block_size", 0),
            "metrics": self.registry.snapshot(),
            "traces": list(self._recent_traces),
        }
