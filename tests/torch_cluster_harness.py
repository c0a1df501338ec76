"""Cluster fixtures over the port's modules (``repro_torch.cluster``): the
block and sequence shapes of ``cluster_harness.py``, in-process
memory-backed clusters of the port's ``CacheNodeServer``, and child-process
nodes that run ``python -m repro_torch.cluster.node``.

``test_torch_cluster_*.py`` build their topologies from here; the
reference suites keep ``cluster_harness.py``.
"""

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.cluster import CacheNodeServer, ClusterKVBlockStore, NodeProcess, spawn_local_node
from repro_torch.core.baselines import MemoryOnlyStore

B = 4  # tokens per block, as in cluster_harness.py


def blocks(rng, n, dtype=np.float32):
    return [rng.standard_normal((2, B, 4)).astype(dtype) for _ in range(n)]


def seq(rng, nblocks):
    return [int(x) for x in rng.integers(0, 50_000, nblocks * B)]


def mem_server(server_cls=CacheNodeServer, store_cls=MemoryOnlyStore, **kw):
    """One in-process memory-backed node (real socket), started."""
    return server_cls(store_cls(1 << 26, block_size=B), io_threads=1, **kw).start()


def mem_cluster(n: int, replication: int, **kw) -> Tuple[List[CacheNodeServer], ClusterKVBlockStore]:
    """N in-process memory-backed port node servers plus a connected port
    cluster client with fail-fast retry settings.  Caller closes both
    (``close_all``)."""
    servers = [mem_server() for _ in range(n)]
    cluster = ClusterKVBlockStore([s.address for s in servers], replication=replication, retries=0,
                                  connect_timeout_s=2.0, **kw)
    return servers, cluster


def add_mem_node(servers: List[CacheNodeServer]) -> CacheNodeServer:
    servers.append(mem_server())
    return servers[-1]


def close_all(cluster: Optional[ClusterKVBlockStore], servers) -> None:
    """Close the client, then every server (some may be dead already)."""
    if cluster is not None:
        cluster.close()
    for s in servers:
        s.close()


def spawn_nodes(root, n: int, *, block_size: int = B, backend: str = "memory", codec: str = "raw",
                io_threads: int = 1, ready_timeout_s: float = 120.0, **kw) -> List[NodeProcess]:
    """N child-process port nodes under ``root``, each waited on for its
    READY line (a generous deadline: a loaded host can take long to start
    an interpreter)."""
    return [spawn_local_node(str(root / f"n{i}"), block_size=block_size, backend=backend, codec=codec,
                             io_threads=io_threads, ready_timeout_s=ready_timeout_s, **kw)
            for i in range(n)]
