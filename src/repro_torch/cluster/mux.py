"""Client-side connection multiplexing: one socket per node, many RPCs
in flight.

The old transport pooled sockets and parked one thread per outstanding
RPC inside ``recv`` — in-flight depth equaled pool size, and a batch of
small probes serialized behind one large get.  Here a single
``MuxLoop`` selector thread owns the *read* side of every node
connection: it drains sockets, reassembles length-prefixed frames,
routes each frame by request id to the waiter that issued it, and hands
the bytes over — decode happens on the waiting caller's thread, so the
loop never stalls the sockets behind tensor decode CPU.

Writes go straight from caller threads (serialized per connection by a
send lock, bounded by the socket timeout); the kernel interleaves the
two directions, which is what makes the protocol full duplex: a
``get_batch`` stream can be arriving while the next batch of requests
is going out.

Failure semantics, per the cluster error taxonomy:

* socket errors, timeouts, and framing violations poison the whole
  connection — every pending waiter fails with the transport error, and
  the caller maps it to retry / ``NodeUnavailable``;
* malformed frame *bodies* are the receiving caller's problem
  (``ProtocolError`` raised from its decode, never retried) — the frame
  boundary itself was sound, so other requests on the connection are
  unaffected.
"""

from __future__ import annotations

import queue
import selectors
import socket
import threading
from typing import Dict, Optional, Union

from . import protocol as P

_DONTWAIT = getattr(socket, "MSG_DONTWAIT", 0)


class _UnaryWaiter:
    """One caller blocked on a single RESPONSE frame."""

    __slots__ = ("_event", "payload", "exc")

    def __init__(self):
        self._event = threading.Event()
        self.payload: Optional[bytes] = None
        self.exc: Optional[BaseException] = None

    def complete(self, payload: bytes) -> None:
        self.payload = payload
        self._event.set()

    def fail(self, exc: BaseException) -> None:
        self.exc = exc
        self._event.set()

    def wait(self, timeout: Optional[float]) -> bytes:
        if not self._event.wait(timeout):
            raise socket.timeout(f"no response within {timeout}s")
        if self.exc is not None:
            raise self.exc
        assert self.payload is not None
        return self.payload


class _StreamWaiter:
    """One caller consuming CHUNK frames until END.  Events are
    ``("chunk", bytes)``, ``("end", bytes)`` or ``("err", exc)``."""

    __slots__ = ("_q",)

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()

    def complete(self, payload: bytes) -> None:  # RESPONSE to a stream op
        self._q.put(("err", P.ProtocolError("unary response to a streaming request")))

    def feed_chunk(self, payload: bytes) -> None:
        self._q.put(("chunk", payload))

    def finish(self, payload: bytes) -> None:
        self._q.put(("end", payload))

    def fail(self, exc: BaseException) -> None:
        self._q.put(("err", exc))

    def next_event(self, timeout: Optional[float]):
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            raise socket.timeout(f"no stream frame within {timeout}s") from None


Waiter = Union[_UnaryWaiter, _StreamWaiter]


class MuxConnection:
    """One multiplexed connection.  Callers attach a waiter, send their
    tagged request, and block on the waiter; the loop thread routes
    arriving frames by request id."""

    def __init__(
        self,
        sock: socket.socket,
        loop: "MuxLoop",
        max_frame_bytes: int = P.MAX_FRAME_BYTES,
        timeout_s: float = 30.0,
    ):
        sock.settimeout(timeout_s)  # bounds writes; reads ride the selector
        self.sock = sock
        self.loop = loop
        self.max_frame_bytes = max_frame_bytes
        self.timeout_s = timeout_s
        self.alive = True
        self._buf = bytearray()
        self._wlock = threading.Lock()  # serializes frame writes
        self._plock = threading.Lock()  # pending map + rid allocation + alive
        self._pending: Dict[int, Waiter] = {}
        self._next_rid = 1
        self.orphan_frames = 0  # frames for an rid nobody is waiting on
        loop.register(self)

    # ------------------------------------------------------------- send side
    def attach(self, waiter: Waiter) -> int:
        """Reserve a request id for ``waiter``; the caller must send the
        request (or ``detach``) afterwards."""
        with self._plock:
            if not self.alive:
                raise ConnectionError("connection is closed")
            rid = self._next_rid
            self._next_rid = (self._next_rid + 1) & 0xFFFFFFFF or 1
            self._pending[rid] = waiter
            return rid

    def detach(self, rid: int) -> None:
        with self._plock:
            self._pending.pop(rid, None)

    def send_request(self, rid: int, request: bytes,
                     trace: Optional[bytes] = None) -> int:
        """Write one tagged REQUEST frame; returns bytes sent.  ``trace``
        rides as the optional trace-id field of the mux header.  A send
        failure poisons the connection (the stream position is unknown)."""
        parts = [P.pack_mux(rid, P.KIND_REQUEST, trace), request]
        try:
            with self._wlock:
                return P.send_frame_parts(self.sock, parts)
        except OSError as e:
            self.poison(e)
            raise

    # ------------------------------------------------------------- loop side
    def on_readable(self) -> None:
        """Loop thread: drain the socket, route complete frames."""
        for _ in range(8):  # bounded so one firehose conn can't starve others
            try:
                data = self.sock.recv(1 << 20, _DONTWAIT)
            except (BlockingIOError, InterruptedError):
                return
            except OSError as e:
                self.poison(e)
                return
            if not data:
                self.poison(
                    P.TruncatedFrame("peer closed mid-RPC")
                    if self._pending_count()
                    else ConnectionError("peer closed the connection")
                )
                return
            self._buf += data
            if not self._route_frames():
                return
            if len(data) < (1 << 20):
                return

    def _pending_count(self) -> int:
        with self._plock:
            return len(self._pending)

    def _route_frames(self) -> bool:
        while len(self._buf) >= 4:
            length = int.from_bytes(self._buf[:4], "big")
            if length > self.max_frame_bytes:
                self.poison(P.FrameTooLarge(f"frame of {length} bytes exceeds cap"))
                return False
            if len(self._buf) < 4 + length:
                break
            payload = bytes(self._buf[4 : 4 + length])
            del self._buf[: 4 + length]
            try:
                rid, kind, body = P.split_mux(payload)
            except P.ProtocolError as e:
                self.poison(e)  # framing is broken — nothing on this conn is safe
                return False
            self._route(rid, kind, bytes(body))
        return True

    def _route(self, rid: int, kind: int, body: bytes) -> None:
        with self._plock:
            waiter = self._pending.get(rid)
            if kind in (P.KIND_RESPONSE, P.KIND_END):
                self._pending.pop(rid, None)
        if waiter is None:
            self.orphan_frames += 1  # late frame for a timed-out/abandoned rid
            return
        if kind == P.KIND_RESPONSE:
            waiter.complete(body)
        elif kind == P.KIND_CHUNK:
            if isinstance(waiter, _StreamWaiter):
                waiter.feed_chunk(body)
            else:
                waiter.fail(P.ProtocolError("stream chunk for a unary request"))
        elif kind == P.KIND_END:
            if isinstance(waiter, _StreamWaiter):
                waiter.finish(body)
            else:
                waiter.fail(P.ProtocolError("stream end for a unary request"))
        else:  # KIND_REQUEST from a server is nonsense
            waiter.fail(P.ProtocolError(f"unexpected frame kind {kind}"))

    # -------------------------------------------------------------- teardown
    def poison(self, exc: BaseException) -> None:
        """Fail every pending waiter and close the socket.  Idempotent;
        safe from any thread."""
        with self._plock:
            if not self.alive:
                return
            self.alive = False
            pending, self._pending = self._pending, {}
        self.loop.unregister(self)
        try:
            self.sock.close()
        except OSError:
            pass
        for waiter in pending.values():
            waiter.fail(exc)

    def close(self) -> None:
        self.poison(ConnectionError("connection closed by client"))


class MuxLoop:
    """The client I/O loop: one daemon thread selecting over every
    registered ``MuxConnection``.  Shared across all node clients of a
    cluster store, so client-side read concurrency costs one thread
    total, not one per in-flight RPC."""

    def __init__(self):
        self._selector = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._selector.register(self._wake_r, selectors.EVENT_READ, None)
        self._lock = threading.Lock()
        self._pending_reg: list = []
        self._pending_unreg: list = []
        self._closed = False
        self._thread = threading.Thread(target=self._run, name="mux-loop", daemon=True)
        self._thread.start()

    def register(self, conn: MuxConnection) -> None:
        with self._lock:
            if self._closed:
                raise RuntimeError("MuxLoop is closed")
            self._pending_reg.append(conn)
        self._wake()

    def unregister(self, conn: MuxConnection) -> None:
        with self._lock:
            if conn in self._pending_reg:
                self._pending_reg.remove(conn)
            else:
                self._pending_unreg.append(conn)
        self._wake()

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    def _run(self) -> None:
        registered: set = set()
        while True:
            with self._lock:
                closed = self._closed
                reg, self._pending_reg = self._pending_reg, []
                unreg, self._pending_unreg = self._pending_unreg, []
            if closed:
                for conn in registered:
                    conn.poison(ConnectionError("mux loop shut down"))
                return
            for conn in unreg:
                if conn in registered:
                    registered.discard(conn)
                    try:
                        self._selector.unregister(conn.sock)
                    except (KeyError, ValueError, OSError):
                        pass
            for conn in reg:
                try:
                    self._selector.register(conn.sock, selectors.EVENT_READ, conn)
                    registered.add(conn)
                except (ValueError, OSError) as e:
                    conn.poison(e if isinstance(e, OSError) else ConnectionError(str(e)))
            for key, _ in self._selector.select(timeout=0.5):
                if key.data is None:
                    try:
                        self._wake_r.recv(4096)
                    except OSError:
                        pass
                else:
                    key.data.on_readable()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._wake()
        self._thread.join(timeout=10)
        try:
            self._selector.close()
        except OSError:
            pass
        self._wake_r.close()
        self._wake_w.close()
