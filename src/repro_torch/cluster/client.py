"""``RemoteKVBlockStore`` — a ``StorageBackend`` whose storage lives in
another process.

The client speaks the multiplexed frame protocol to one
``CacheNodeServer`` and exposes the full backend contract, so everything
built against the protocol (``CacheHierarchy``, ``ServingEngine``, the
write-behind ``CommitQueue``, benchmarks) runs against a remote node
unchanged — the network hop is a constructor argument, never a code
change.

Mechanics:

* **Multiplexing** — one connection per node; every RPC is tagged with a
  request id, so any number of callers (the engine's I/O executor, the
  commit-queue drain thread) have requests in flight *concurrently* on
  the same socket, and responses return in whatever order the node
  finishes them.  The read side is serviced by a shared ``MuxLoop``
  selector thread (pass ``mux_loop`` to share one loop across a whole
  cluster's clients); decode runs on the calling thread.
* **Streaming gets** — ``get_batch_stream`` yields blocks as their
  chunks arrive, so a consumer starts on block 0 while blocks 1..N are
  still on the wire; ``get_batch``/``get_many`` are assembled from the
  same chunk stream.  ``BlockStream.first_block_s`` measures
  time-to-first-block, the metric the serving benchmarks report.
* **Request batching** — the multi-sequence ops (``probe_many`` /
  ``get_many`` / ``put_many``) ship as *one* RPC, so a whole engine
  batch pays one round trip instead of one per sequence.  ``put_many``
  batches are split when their payload would approach the frame cap.

Error taxonomy (strict, and load-bearing for the cluster layer):

* **Transport errors** — socket errors, timeouts, connection loss, and
  *framing* violations (``TruncatedFrame``, ``FrameTooLarge``) — are
  retried on a fresh connection up to ``retries`` times; persistent
  failure raises ``NodeUnavailable``, the signal the cluster store uses
  to mark the node down and fail over.  Every backend op is idempotent
  (puts are content-addressed, probes and gets are reads), so retry is
  always safe.  A stream that breaks after its first chunk is **not**
  retried here — it raises ``NodeUnavailable`` immediately so the
  caller can fail over to a replica without re-paying the prefix.
* **Application errors** — ``RemoteError`` (the node ran the op and
  reported a failure) and ``ProtocolError`` from *body* decode (the
  frame arrived whole but its contents are malformed) — are never
  retried and never mapped to ``NodeUnavailable``: they indicate a bug
  or corruption, not an unreachable node, and hiding them behind retry
  would turn data errors into spurious failovers.

On any error path the request id is detached before the exception
propagates, so a waiter is never leaked; a send failure or framing
violation poisons the whole connection (its stream position is
unknown), failing all of its in-flight requests with the transport
error, and the next RPC dials fresh.
"""

from __future__ import annotations

import threading
import time
import socket
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core.store import StoreStats
from ..obs.tracing import current_trace
from . import protocol as P
from .mux import MuxConnection, MuxLoop, _StreamWaiter, _UnaryWaiter
from .server import Address

# transport-level failures: retryable, and the NodeUnavailable trigger.
# Plain ProtocolError (malformed body) is deliberately NOT here.
TRANSPORT_ERRORS = (OSError, P.TruncatedFrame, P.FrameTooLarge)


class NodeUnavailable(ConnectionError):
    """The node could not be reached (after retries)."""


@dataclass
class RpcStats:
    rpcs: int = 0
    retries: int = 0
    connects: int = 0
    failures: int = 0  # RPCs abandoned after all retries
    bytes_sent: int = 0
    bytes_received: int = 0
    streams: int = 0
    stream_chunks: int = 0
    stream_blocks: int = 0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class BlockStream:
    """Iterator over one sequence's blocks as they arrive off the wire.

    ``first_block_s`` is the wall-clock delay from request send to the
    first block being available (time-to-first-block); ``served`` counts
    blocks yielded so far.  Iteration raises ``NodeUnavailable`` if the
    transport dies mid-stream — a partial prefix was yielded, and it is
    the *caller's* job to treat it as partial (the cluster store resumes
    from a replica; the hierarchy truncates to what arrived)."""

    def __init__(self, events: Iterator):
        self._events = events
        self._t0 = time.perf_counter()
        self.first_block_s: Optional[float] = None
        self.served = 0

    def __iter__(self):
        for kind, data in self._events:
            if kind == "chunk":
                _, start_block, blocks = data
                if start_block != self.served:
                    raise P.ProtocolError(
                        f"stream chunk starts at block {start_block}, expected {self.served}"
                    )
                for b in blocks:
                    if self.first_block_s is None:
                        self.first_block_s = time.perf_counter() - self._t0
                    self.served += 1
                    yield b
            else:  # end
                counts = data
                if counts and counts[0] != self.served:
                    raise P.ProtocolError(
                        f"stream end reports {counts[0]} blocks, received {self.served}"
                    )
                return

    def close(self) -> None:
        self._events.close()


class RemoteKVBlockStore:
    """Client-side ``StorageBackend`` over one remote cache node."""

    name = "remote"

    def __init__(
        self,
        address: Address,
        block_size: Optional[int] = None,
        timeout_s: float = 30.0,
        connect_timeout_s: float = 5.0,
        retries: int = 2,
        max_frame_bytes: int = P.MAX_FRAME_BYTES,
        put_chunk_bytes: int = 32 * 1024 * 1024,
        chunk_blocks: int = 4,
        mux_loop: Optional[MuxLoop] = None,
        pool_size: Optional[int] = None,  # retained for compat; mux needs one conn
    ):
        """``block_size=None`` fetches it from the node at construction
        (requires the node to be up); pass it explicitly to construct a
        client for a node that may currently be down.  ``chunk_blocks``
        is the streaming granularity requested from the node (blocks per
        CHUNK frame).  Pass a shared ``mux_loop`` to run many node
        clients off one selector thread (the cluster store does)."""
        self.address = address
        self.timeout_s = timeout_s
        self.connect_timeout_s = connect_timeout_s
        self.retries = retries
        self.max_frame_bytes = max_frame_bytes
        self.put_chunk_bytes = put_chunk_bytes
        self.chunk_blocks = max(1, int(chunk_blocks))
        self.rpc_stats = RpcStats()
        self._lock = threading.Lock()
        self._mux: Optional[MuxConnection] = None
        self._owns_loop = mux_loop is None
        self._loop = mux_loop if mux_loop is not None else MuxLoop()
        self._closed = False
        if block_size is None:
            block_size = int(self._rpc(P.OP_STATS)["block_size"])
        self.block_size = block_size

    # ------------------------------------------------------------ transport
    def _dial(self) -> socket.socket:
        try:
            if isinstance(self.address, str):
                sock = socket.socket(socket.AF_UNIX)
                sock.settimeout(self.connect_timeout_s)
                sock.connect(self.address)
            else:
                sock = socket.create_connection(
                    tuple(self.address), timeout=self.connect_timeout_s
                )
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError as e:
            raise NodeUnavailable(f"connect to {self.address}: {e}") from e
        with self._lock:
            self.rpc_stats.connects += 1
        return sock

    def _conn(self) -> MuxConnection:
        with self._lock:
            if self._closed:
                raise NodeUnavailable(f"client for {self.address} is closed")
            if self._mux is not None and self._mux.alive:
                return self._mux
        sock = self._dial()
        conn = MuxConnection(sock, self._loop, self.max_frame_bytes, self.timeout_s)
        with self._lock:
            if self._closed or (self._mux is not None and self._mux.alive):
                # lost the dial race (or closed meanwhile): keep the winner
                winner = self._mux
                conn.close()
                if self._closed or winner is None:
                    raise NodeUnavailable(f"client for {self.address} is closed")
                return winner
            self._mux = conn
            return conn

    def _transport_call(self, op: int, args: tuple) -> bytes:
        """One attempt: send a tagged request, wait for its RESPONSE.
        Raises only transport errors (or the caller's own bugs)."""
        request = P.encode_request(op, *args)
        if len(request) + 4 + P.MUX_HDR_BYTES > self.max_frame_bytes:
            raise ValueError(
                f"request of {len(request)} bytes exceeds frame cap "
                f"{self.max_frame_bytes}; split the batch"
            )
        conn = self._conn()
        waiter = _UnaryWaiter()
        rid = conn.attach(waiter)
        tr = current_trace()
        try:
            sent = conn.send_request(rid, request,
                                     trace=tr.id_bytes() if tr else None)
            payload = waiter.wait(self.timeout_s)
        finally:
            conn.detach(rid)  # never leak a waiter, success or not
        with self._lock:
            self.rpc_stats.rpcs += 1
            self.rpc_stats.bytes_sent += sent
            self.rpc_stats.bytes_received += len(payload) + 4 + P.MUX_HDR_BYTES
        return payload

    def _rpc(self, op: int, *args):
        last: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            if attempt:
                with self._lock:
                    self.rpc_stats.retries += 1
            try:
                payload = self._transport_call(op, args)
            except NodeUnavailable as e:
                last = e
                continue
            except TRANSPORT_ERRORS as e:
                last = e
                continue
            # Decode outside the retry net: RemoteError (node reported a
            # failure) and ProtocolError (malformed body) are application
            # errors — raising them here, not retrying, is the contract.
            return P.decode_response(op, payload)
        with self._lock:
            self.rpc_stats.failures += 1
        raise NodeUnavailable(f"node {self.address} unreachable: {last}") from last

    def ping(self) -> bool:
        """One round trip; ``False`` if the node is unreachable."""
        try:
            self._rpc(P.OP_PING)
            return True
        except NodeUnavailable:
            return False

    # ------------------------------------------------------------ streaming
    def _stream_events(self, op: int, *args) -> Iterator:
        """Generator of decoded stream events: ``("chunk", (seq_index,
        start_block, blocks))`` then ``("end", counts)``.  Transport
        failures are retried only while nothing has arrived; after the
        first chunk they raise ``NodeUnavailable`` (the caller fails
        over rather than re-pulling the prefix)."""
        request = P.encode_request(op, *args)
        last: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            if attempt:
                with self._lock:
                    self.rpc_stats.retries += 1
            got_any = False
            try:
                conn = self._conn()
                waiter = _StreamWaiter()
                rid = conn.attach(waiter)
                tr = current_trace()
                try:
                    sent = conn.send_request(rid, request,
                                             trace=tr.id_bytes() if tr else None)
                    with self._lock:
                        self.rpc_stats.streams += 1
                        self.rpc_stats.bytes_sent += sent
                    while True:
                        kind, payload = waiter.next_event(self.timeout_s)
                        if kind == "err":
                            raise payload
                        with self._lock:
                            self.rpc_stats.bytes_received += len(payload) + 4 + P.MUX_HDR_BYTES
                        if kind == "chunk":
                            got_any = True
                            seq, start, blocks = P.decode_stream_chunk(payload)
                            with self._lock:
                                self.rpc_stats.stream_chunks += 1
                                self.rpc_stats.stream_blocks += len(blocks)
                            yield ("chunk", (seq, start, blocks))
                        else:  # end
                            yield ("end", P.decode_stream_end(payload))
                            return
                finally:
                    conn.detach(rid)
            except NodeUnavailable as e:
                last = e
            except TRANSPORT_ERRORS as e:
                last = e
            if got_any:
                # mid-stream loss: the caller has a partial prefix; do not
                # silently restart — surface it for replica failover
                with self._lock:
                    self.rpc_stats.failures += 1
                raise NodeUnavailable(
                    f"node {self.address} died mid-stream: {last}"
                ) from last
        with self._lock:
            self.rpc_stats.failures += 1
        raise NodeUnavailable(f"node {self.address} unreachable: {last}") from last

    def get_batch_stream(
        self, tokens: Sequence[int], n_tokens: int, chunk_blocks: Optional[int] = None
    ) -> BlockStream:
        """Stream the cached blocks covering ``tokens[:n_tokens]`` as
        they arrive.  Lazy: the request is sent on first iteration, and
        ``first_block_s`` measures from construction — construct and
        consume promptly."""
        cb = self.chunk_blocks if chunk_blocks is None else max(1, int(chunk_blocks))
        events = self._stream_events(
            P.OP_GET_STREAM, list(tokens), int(n_tokens), cb
        )
        return BlockStream(events)

    # ------------------------------------------------------------- contract
    def put_batch(
        self,
        tokens: Sequence[int],
        blocks: Sequence[np.ndarray],
        start_block: int = 0,
        skip_existing: bool = True,
    ) -> int:
        return int(
            self._rpc(P.OP_PUT, list(tokens), list(blocks), start_block, skip_existing)
        )

    def probe(self, tokens: Sequence[int]) -> int:
        return int(self._rpc(P.OP_PROBE, list(tokens)))

    def get_batch(self, tokens: Sequence[int], n_tokens: int) -> List[np.ndarray]:
        return list(self.get_batch_stream(tokens, n_tokens))

    def probe_many(self, seqs: Sequence[Sequence[int]]) -> List[int]:
        if not seqs:
            return []
        return [int(v) for v in self._rpc(P.OP_PROBE_MANY, [list(s) for s in seqs])]

    def get_many(
        self, items: Sequence[Tuple[Sequence[int], int]]
    ) -> List[List[np.ndarray]]:
        if not items:
            return []
        out: List[List[np.ndarray]] = [[] for _ in items]
        events = self._stream_events(
            P.OP_GET_MANY_STREAM,
            [(list(t), int(n)) for t, n in items],
            self.chunk_blocks,
        )
        for kind, data in events:
            if kind == "chunk":
                si, start, blocks = data
                if si >= len(out) or start != len(out[si]):
                    raise P.ProtocolError(
                        f"stream chunk for seq {si} starts at {start}, "
                        f"expected {len(out[si]) if si < len(out) else '<bad seq>'}"
                    )
                out[si].extend(blocks)
            else:
                counts = data
                if counts != [len(o) for o in out]:
                    raise P.ProtocolError(
                        f"stream end counts {counts} != received {[len(o) for o in out]}"
                    )
        return out

    def put_many(
        self, items: Sequence[Tuple[Sequence[int], Sequence[np.ndarray], int]]
    ) -> List[int]:
        if not items:
            return []
        # chunk by payload bytes so one giant batch can't trip the frame cap
        out: List[int] = []
        chunk: list = []
        chunk_bytes = 0
        for tokens, blocks, start in items:
            nbytes = sum(np.asarray(b).nbytes for b in blocks)
            if chunk and chunk_bytes + nbytes > self.put_chunk_bytes:
                out.extend(int(v) for v in self._rpc(P.OP_PUT_MANY, chunk))
                chunk, chunk_bytes = [], 0
            chunk.append((list(tokens), list(blocks), int(start)))
            chunk_bytes += nbytes
        if chunk:
            out.extend(int(v) for v in self._rpc(P.OP_PUT_MANY, chunk))
        return out

    # -------------------------------------------------- elasticity (migration)
    # All three are idempotent (scan/pull are reads; push dedups on the
    # receiving node), so the generic transport retry applies unchanged.

    def scan_keys(
        self,
        cursor: Optional[bytes] = None,
        limit: int = 1024,
        ranges: Sequence[Tuple[int, int]] = (),
    ) -> Tuple[List[bytes], Optional[bytes]]:
        """One page of the node's live keys (``(keys, next_cursor)``),
        optionally filtered to the given half-open wrapping ring arcs.
        ``limit`` bounds keys *examined* node-side, so a filtered page may
        come back short — or empty with a non-None cursor; loop until the
        cursor is None."""
        keys, next_cursor = self._rpc(P.OP_SCAN, cursor, int(limit), list(ranges))
        return keys, next_cursor

    def export_encoded(self, keys: Sequence[bytes]) -> List[Optional[Tuple[int, bytes]]]:
        """Stored records for ``keys`` as ``(tier_flags, payload)`` pairs in
        their stored encoding (``None`` where absent), aligned with ``keys``."""
        if not keys:
            return []
        return self._rpc(P.OP_PULL, [bytes(k) for k in keys])

    def import_encoded(self, records, skip_existing: bool = True) -> int:
        """Push ``(key, flags, payload)`` records to the node verbatim;
        returns blocks actually written (duplicates skipped).  Batches are
        split by payload bytes so one migration page cannot trip the
        frame cap."""
        total = 0
        chunk: list = []
        chunk_bytes = 0
        for key, flags, payload in records:
            if chunk and chunk_bytes + len(payload) > self.put_chunk_bytes:
                total += int(self._rpc(P.OP_PUSH, chunk, skip_existing))
                chunk, chunk_bytes = [], 0
            chunk.append((bytes(key), int(flags), bytes(payload)))
            chunk_bytes += len(payload)
        if chunk:
            total += int(self._rpc(P.OP_PUSH, chunk, skip_existing))
        return total

    def maintenance(self, compact_steps: int = 8) -> dict:
        return self._rpc(P.OP_MAINTENANCE, int(compact_steps))

    def flush(self) -> None:
        self._rpc(P.OP_FLUSH)

    def close(self) -> None:
        """Close the client's connection (the node itself stays up — its
        lifecycle belongs to whoever spawned it)."""
        with self._lock:
            self._closed = True
            conn, self._mux = self._mux, None
        if conn is not None:
            conn.close()
        if self._owns_loop:
            self._loop.close()

    # ---------------------------------------------------------------- stats
    def node_report(self) -> dict:
        """Raw node-side report: store stats + server transport counters,
        plus this client's own transport-level view."""
        report = self._rpc(P.OP_STATS)
        report["client"] = self.rpc_stats.as_dict()
        return report

    def metrics(self) -> dict:
        """The node's full metrics-registry snapshot (``OP_METRICS``):
        counters, gauges, latency histograms with p50/p95/p99, and the
        recent trace ids the node closed out."""
        return self._rpc(P.OP_METRICS)

    @property
    def stats(self) -> StoreStats:
        remote = self.node_report()["stats"]
        out = StoreStats()
        for k, v in remote.items():
            if hasattr(out, k):
                setattr(out, k, v)
        return out

    @property
    def disk_bytes(self) -> int:
        return int(self.node_report()["disk_bytes"])

    @property
    def file_count(self) -> int:
        return int(self.node_report()["file_count"])
