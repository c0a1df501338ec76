"""Cache-node process: ``python -m repro_torch.cluster.node --root DIR ...``

Runs one ``CacheNodeServer`` over a local backend until killed — the
deployable unit of the cache cluster.  Imports stay storage-only (no
jax), so a node starts in milliseconds and runs on cacheless CPU hosts.

``spawn_local_node`` / ``NodeProcess`` are the in-repo process manager:
examples, benchmarks, and tests use them to stand up real multi-process
clusters on localhost (the node prints ``READY port=N`` once the socket
is bound; the parent blocks on that line).  Production deployments run
the same module under their own supervisor.
"""

from __future__ import annotations

import argparse
import os
import select
import signal
import subprocess
import sys
import threading
import time
from typing import List, Optional

from ..core.baselines import MemoryOnlyStore
from ..core.codec import CODEC_INT8, CODEC_RAW, BatchCodec
from ..core.sharded_store import ShardedKVBlockStore
from ..core.store import KVBlockStore
from ..core.tiering import TieringPolicy
from .server import CacheNodeServer


def make_backend(args) -> object:
    codec = {
        "raw": BatchCodec(CODEC_RAW, use_zlib=False),
        "int8": BatchCodec(CODEC_INT8, use_zlib=False),
        "int8-zlib": BatchCodec(CODEC_INT8, use_zlib=True),
        "tiered": None,  # adaptive policy: puts are raw, maintenance demotes
    }[args.codec]
    budget = args.budget_bytes if args.budget_bytes > 0 else None
    if args.backend == "memory":
        return MemoryOnlyStore(budget or 1 << 30, block_size=args.block_size)
    extra = {}
    if args.vlog_file_bytes > 0:
        extra["vlog_file_bytes"] = args.vlog_file_bytes
    if args.codec == "tiered":
        extra["tiering"] = TieringPolicy(
            warm_after_s=args.warm_after_s, cold_after_s=args.cold_after_s
        )
    if args.backend == "sharded":
        return ShardedKVBlockStore(
            args.root, n_shards=args.shards, block_size=args.block_size,
            codec=codec, budget_bytes=budget, io_threads=args.store_io_threads,
            **extra,
        )
    return KVBlockStore(args.root, block_size=args.block_size, codec=codec,
                        budget_bytes=budget, **extra)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one KV-cache cluster node")
    ap.add_argument("--root", required=True, help="backend data directory")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0, help="0 = ephemeral")
    ap.add_argument("--unix-path", default=None, help="serve AF_UNIX instead of TCP")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--backend", choices=("lsm", "sharded", "memory"), default="lsm")
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--codec", choices=("raw", "int8", "int8-zlib", "tiered"),
                    default="int8-zlib",
                    help="'tiered' writes raw and lets maintenance demote "
                         "idle blocks to int8 / int8+zlib (core.tiering)")
    ap.add_argument("--warm-after-s", type=float, default=30.0,
                    help="tiered codec: demote a sealed log file idle this "
                         "long to int8 (0 = next maintenance cycle)")
    ap.add_argument("--cold-after-s", type=float, default=120.0,
                    help="tiered codec: demote to int8+zlib after this idle")
    ap.add_argument("--budget-bytes", type=int, default=0, help="0 = unbounded")
    ap.add_argument("--vlog-file-bytes", type=int, default=0,
                    help="tensor-log roll size; 0 = backend default (bounds "
                         "FIFO-eviction granularity for budgeted nodes)")
    ap.add_argument("--io-threads", type=int, default=2,
                    help="server-side request concurrency (the node's serving width)")
    ap.add_argument("--store-io-threads", type=int, default=0,
                    help="sharded backend's internal fan-out threads")
    ap.add_argument("--no-zero-copy", action="store_true",
                    help="disable the sendfile streaming path (A/B measurement)")
    ap.add_argument("--metrics-port", type=int, default=-1,
                    help="serve Prometheus text exposition of the node's "
                         "metrics registry on this HTTP port (0 = ephemeral, "
                         "-1 = disabled)")
    args = ap.parse_args(argv)

    backend = make_backend(args)
    server = CacheNodeServer(
        backend, host=args.host, port=args.port, unix_path=args.unix_path,
        io_threads=args.io_threads, zero_copy=not args.no_zero_copy,
    ).start()
    httpd = None
    if args.metrics_port >= 0:
        from ..obs.httpd import MetricsHTTPServer
        httpd = MetricsHTTPServer(server.registry, host=args.host,
                                  port=args.metrics_port)
        # printed before READY so spawn_local_node picks it up while
        # scanning for the READY line
        print(f"METRICS port={httpd.port}", flush=True)
    if isinstance(server.address, str):
        print(f"READY unix={server.address}", flush=True)
    else:
        print(f"READY port={server.address[1]}", flush=True)

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    if httpd is not None:
        httpd.close()
    server.close()
    backend.flush()
    backend.close()
    return 0


# ------------------------------------------------------------ spawn helpers
class NodeProcess:
    """Handle on one spawned local node: address + process control."""

    def __init__(self, proc: subprocess.Popen, address, root: str,
                 metrics_port: Optional[int] = None):
        self.proc = proc
        self.address = address
        self.root = root
        self.metrics_port = metrics_port  # HTTP exposition port, if enabled

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        """Hard kill (SIGKILL) — the failure the failover demo injects."""
        if self.alive:
            self.proc.kill()
            self.proc.wait(timeout=10)

    def terminate(self) -> None:
        if self.alive:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.kill()

    def close(self) -> None:
        self.terminate()
        if self.proc.stdout is not None:
            self.proc.stdout.close()


def spawn_local_node(
    root: str,
    port: int = 0,
    host: str = "127.0.0.1",
    block_size: int = 16,
    backend: str = "lsm",
    codec: str = "int8-zlib",
    io_threads: int = 2,
    budget_bytes: int = 0,
    vlog_file_bytes: int = 0,
    ready_timeout_s: float = 30.0,
    metrics_port: Optional[int] = None,
    extra_args: Optional[List[str]] = None,
) -> NodeProcess:
    """Start ``python -m repro_torch.cluster.node`` as a child process and block
    until its socket is bound (the ``READY`` line).  ``metrics_port``
    enables the HTTP exposition endpoint (0 = ephemeral; the bound port
    comes back on the handle's ``metrics_port``)."""
    src_dir = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = src_dir + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [
        sys.executable, "-m", "repro_torch.cluster.node",
        "--root", root, "--host", host, "--port", str(port),
        "--block-size", str(block_size), "--backend", backend,
        "--codec", codec, "--io-threads", str(io_threads),
        "--budget-bytes", str(budget_bytes),
        "--vlog-file-bytes", str(vlog_file_bytes),
    ] + (extra_args or [])
    if metrics_port is not None:
        cmd += ["--metrics-port", str(metrics_port)]
    proc = subprocess.Popen(
        cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    deadline = time.time() + ready_timeout_s
    bound_metrics: Optional[int] = None
    address = None
    # Read the raw fd and split lines by hand: select() + buffered
    # readline() race when the child prints METRICS and READY
    # back-to-back — one readline() can pull both lines into the
    # userspace buffer and return only the first, after which select()
    # on the drained OS pipe never fires again.
    fd = proc.stdout.fileno()
    pending = b""
    last = ""
    while time.time() < deadline and address is None:
        if proc.poll() is not None:
            out = pending.decode(errors="replace") + (proc.stdout.read() or "")
            raise RuntimeError(f"node exited at startup (rc={proc.returncode}): {out}")
        readable, _, _ = select.select([fd], [], [], 0.25)
        if not readable:
            continue
        chunk = os.read(fd, 4096)
        if not chunk:
            continue  # EOF: let proc.poll() report the exit
        pending += chunk
        while b"\n" in pending:
            raw, _, pending = pending.partition(b"\n")
            last = raw.decode(errors="replace")
            if last.startswith("METRICS"):  # printed before READY
                bound_metrics = int(last.split("METRICS", 1)[1].strip().partition("=")[2])
            elif last.startswith("READY"):
                token = last.split("READY", 1)[1].strip()
                key, _, value = token.partition("=")
                address = value if key == "unix" else (host, int(value))
                break
    if address is None:
        proc.kill()
        raise TimeoutError(f"node gave no READY within {ready_timeout_s}s: {last!r}")
    return NodeProcess(proc, address, root, metrics_port=bound_metrics)


if __name__ == "__main__":
    sys.exit(main())
