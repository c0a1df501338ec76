"""Cache-cluster layer: thread-safe ``StorageBackend``s served over
sockets, consumed through a consistent-hash-routed, replicated client.

This package is the *cache distribution* axis of the repo — scaling the
disk tier across processes and hosts (LMCache-style cache cluster).  It
is unrelated to ``repro.distributed``, which shards *model training*
(JAX meshes).  See ``docs/ARCHITECTURE.md``.

    CacheNodeServer     one node: pipelined socket RPC shim over any
                        backend (sendmsg scatter-gather + sendfile
                        zero-copy streaming)
    RemoteKVBlockStore  StorageBackend client for one node (multiplexed
                        connection, batched RPCs, streaming gets, retry)
    ClusterKVBlockStore StorageBackend over N nodes (HashRing routing,
                        replication, read-failover — including
                        mid-stream — down/rejoin tracking, elastic
                        add_node/remove_node membership)
    BlockMigrator       background arc migration + replica repair on the
                        maintenance cadence
    MuxLoop             shared client-side selector thread
    spawn_local_node    child-process node manager for demos/benchmarks
"""

from .client import BlockStream, NodeUnavailable, RemoteKVBlockStore, RpcStats
from .cluster_store import ClusterBlockStream, ClusterKVBlockStore, ClusterStats
from .migration import BlockMigrator, MigrationStats
from .mux import MuxConnection, MuxLoop
from .node import NodeProcess, spawn_local_node
from .protocol import (
    MAX_FRAME_BYTES,
    FrameTooLarge,
    ProtocolError,
    RemoteError,
    TruncatedFrame,
)
from .ring import HashRing, TransitionView, key_hash, raw_key_hash
from .server import CacheNodeServer, ServerStats

__all__ = [
    "CacheNodeServer",
    "ServerStats",
    "RemoteKVBlockStore",
    "RpcStats",
    "BlockStream",
    "NodeUnavailable",
    "ClusterKVBlockStore",
    "ClusterBlockStream",
    "ClusterStats",
    "MuxLoop",
    "MuxConnection",
    "HashRing",
    "TransitionView",
    "BlockMigrator",
    "MigrationStats",
    "key_hash",
    "raw_key_hash",
    "NodeProcess",
    "spawn_local_node",
    "ProtocolError",
    "FrameTooLarge",
    "TruncatedFrame",
    "RemoteError",
    "MAX_FRAME_BYTES",
]
