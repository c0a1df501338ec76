"""``ClusterKVBlockStore`` — one ``StorageBackend`` over N remote cache
nodes, routed by a consistent-hash ring.

This is the cross-process analogue of ``ShardedKVBlockStore``: the same
first-block routing hash places every extension of a prefix on the same
node (probes and range scans stay node-local), but placement goes
through a ``HashRing`` instead of ``hash % N`` so membership changes
only remap the failed/joined node's arcs.

Replication and failover:

* ``replication = R`` writes every put to the first R *live* nodes of
  the key's ring preference list.  When a node dies mid-write the put
  slides to the next live node — the cluster degrades to serving with
  R copies among the survivors rather than refusing writes.
* Reads consult the first R live preference nodes and take the best
  answer (probe: max prefix; get: longest block run), so a node that
  missed writes while down — or came back with a cold store — can never
  shorten the answer below what a surviving replica holds.  With R ≥ 2
  a single node failure therefore loses **zero committed blocks**.
* A node that fails an RPC (after the client's retries) is marked
  *down*: routing filters it out everywhere until ``refresh_nodes``
  (called from every ``maintenance`` cycle, or explicitly) pings it
  back.  Rejoin is a pure membership flip — the ring never rehashes, so
  the rejoined node resumes exactly its old arcs (LMCache-style cache
  cluster semantics: nodes are cache, the engine recomputes true
  misses, so rebalance never blocks serving).

Elastic membership (``add_node`` / ``remove_node``):

* A membership change builds a **new** ring and holds both rings as a
  ``TransitionView``: writes target the new owners immediately, reads
  consult the new owners *and* the old owners, so every key is served
  from wherever it currently lives while the move is in flight.
* The attached ``BlockMigrator`` (``cluster.migration``) copies exactly
  the moved ring arcs — and re-replicates arcs that lost a copy to a
  death, when R >= 2 — on the maintenance cadence, shipping blocks in
  their stored encoding.  When the copy drains, the old ring is dropped
  (and a removed node retired from routing).
* Node identity is the ring's vocabulary: routing maps ring node *ids*
  through a stable id->client index, so client slots are append-only
  and an index never changes meaning mid-flight.

Fan-out reuses the grouped-parallel machinery of the sharded store: the
multi-sequence ops group positions by replica set and run the groups
concurrently on an ``IOExecutor``, each group riding the client's
batched RPCs (one round trip per node per group).

Because this class satisfies the ``StorageBackend`` protocol,
``CacheHierarchy``, ``ServingEngine``, the write-behind ``CommitQueue``,
and ``MaintenanceService`` work against a cluster unchanged.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.backend import merge_stats
from ..core.store import StoreStats
from ..obs import MetricsRegistry, dataclass_gauges
from ..runtime.executor import IOExecutor
from .client import NodeUnavailable, RemoteKVBlockStore
from .migration import BlockMigrator
from .mux import MuxLoop
from .ring import HashRing, TransitionView, affected_arcs, key_hash
from .server import Address


@dataclass
class ClusterStats:
    failovers: int = 0  # reads answered by a non-primary replica
    degraded_reads: int = 0  # reads served while >=1 preferred node was down
    marked_down: int = 0
    revived: int = 0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class ClusterKVBlockStore:
    """Consistent-hash routed, replicated client over N cache nodes."""

    name = "cluster"

    def __init__(
        self,
        nodes: Sequence[Union[RemoteKVBlockStore, Address]],
        replication: int = 1,
        block_size: Optional[int] = None,
        vnodes: int = 64,
        io_threads: int = 0,
        io_executor: Optional[IOExecutor] = None,
        node_ids: Optional[Sequence[str]] = None,
        **client_kwargs,
    ):
        """``nodes`` are connected clients or addresses (clients are then
        constructed here with ``client_kwargs``).  ``replication`` is
        clamped to the cluster size; R >= 2 survives single-node loss with
        zero lost committed blocks.

        ``node_ids`` are the stable logical identities hashed onto the
        ring (defaults to ``str(address)``).  Deployments should pass
        durable names: ring placement then survives a node coming back
        on a different port/host, and is reproducible across runs."""
        if not nodes:
            raise ValueError("cluster needs at least one node")
        # one selector thread services every node connection's read side:
        # client-side concurrency is "requests in flight", not threads
        self._mux_loop: Optional[MuxLoop] = None
        if any(not isinstance(n, RemoteKVBlockStore) for n in nodes) and (
            "mux_loop" not in client_kwargs
        ):
            self._mux_loop = MuxLoop()
            client_kwargs = dict(client_kwargs, mux_loop=self._mux_loop)
        self.nodes: List[RemoteKVBlockStore] = []
        for n in nodes:
            if isinstance(n, RemoteKVBlockStore):
                self.nodes.append(n)
            else:
                self.nodes.append(
                    RemoteKVBlockStore(n, block_size=block_size, **client_kwargs)
                )
                block_size = block_size or self.nodes[-1].block_size
        sizes = {c.block_size for c in self.nodes}
        if len(sizes) != 1:
            raise ValueError(f"nodes disagree on block_size: {sorted(sizes)}")
        self.block_size = sizes.pop()
        # retained so later add_node calls build clients the same way, and
        # so replication re-expands when the cluster grows past it
        self._client_kwargs = dict(client_kwargs)
        self._requested_replication = max(1, replication)
        self.replication = max(1, min(replication, len(self.nodes)))
        if node_ids is None:
            node_ids = [str(c.address) for c in self.nodes]
        if len(node_ids) != len(self.nodes) or len(set(node_ids)) != len(node_ids):
            raise ValueError("node_ids must be unique, one per node")
        self.ring = HashRing(list(node_ids), vnodes=vnodes)
        # ring node id -> index into self.nodes.  Client slots are
        # append-only (removed nodes are *retired*, never popped), so an
        # index keeps its meaning across membership changes.
        self._node_index: Dict[str, int] = {nid: i for i, nid in enumerate(node_ids)}
        self.cluster_stats = ClusterStats()
        self._down: set = set()
        self._retired: set = set()
        self._pending_retire: set = set()
        self._down_since: Dict[int, float] = {}  # mark-down monotonic stamps
        self._last_repaired: frozenset = frozenset()
        self._old_ring: Optional[HashRing] = None
        self._transition: Optional[TransitionView] = None
        self._lock = threading.Lock()
        self.migrator = BlockMigrator(self)
        if io_executor is not None:
            self._executor, self._owns_executor = io_executor, False
        elif io_threads > 0:
            # RPC workers block on sockets with the GIL released, so the
            # pool may be wider than the core count (see IOExecutor)
            self._executor = IOExecutor(max_workers=io_threads, cap_to_cpu=False)
            self._owns_executor = True
        else:
            self._executor, self._owns_executor = None, False
        # client-side registry: cluster routing counters plus the summed
        # per-node transport view; node-side metrics ride scrape_cluster()
        self.registry = MetricsRegistry()
        self.registry.register_collector(
            dataclass_gauges("repro_cluster", self.cluster_stats, lock=self._lock,
                             extra=lambda: {
                                 "repro_cluster_nodes": float(len(self.nodes)),
                                 "repro_cluster_live": float(len(self.live_nodes)),
                                 "repro_cluster_replication": float(self.replication),
                             }))
        self.registry.register_collector(
            dataclass_gauges("repro_migration", self.migrator.stats, lock=self._lock,
                             extra=lambda: {
                                 "repro_migration_active": float(self.migrator.active),
                             }))
        self.registry.register_collector(self._rpc_gauges)

    def _rpc_gauges(self) -> Dict[str, float]:
        """Collector: every client's transport stats summed as
        ``repro_rpc_*`` gauges (per-node splits come from the scrape)."""
        out: Dict[str, float] = {}
        for c in self.nodes:
            for k, v in vars(c.rpc_stats).items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    out[f"repro_rpc_{k}"] = out.get(f"repro_rpc_{k}", 0.0) + float(v)
        return out

    # -------------------------------------------------------------- routing
    def _pref_indices(self, khash: int, ring: Optional[HashRing] = None) -> List[int]:
        """A ring's preference list mapped from ring-local indices to
        cluster node indices via node id (ids are the stable vocabulary —
        two rings of different membership agree on them)."""
        ring = ring or self.ring
        return [self._node_index[ring.node_ids[i]] for i in ring.preference(khash)]

    def _live_pref_hash(self, khash: int, read: bool = False) -> List[int]:
        pref = self._pref_indices(khash)
        with self._lock:
            dead = self._down | self._retired
        live = [i for i in pref if i not in dead]
        if not live:
            raise NodeUnavailable("every replica for this key range is down")
        if read and any(i in dead for i in pref[: self.replication]):
            with self._lock:
                self.cluster_stats.degraded_reads += 1
        return live

    def _live_pref(self, tokens: Sequence[int], read: bool = False) -> List[int]:
        """Current-ring preference order with down/retired nodes filtered
        out.  ``read`` marks the call as a read for the degraded-read
        counter (a read whose *ideal* replica set had a down member is
        served, but with less redundancy than configured)."""
        return self._live_pref_hash(key_hash(tokens, self.block_size), read=read)

    def _read_replicas(self, tokens: Sequence[int]) -> List[int]:
        """The node indices a read should consult: the first R live nodes
        of the current ring — plus, during a membership transition, the
        first R live *old-ring* owners, so a key not yet migrated is
        still served from where it lives.  Order is new owners first
        (they are the steady-state answer and warm up as the migrator
        fills them)."""
        khash = key_hash(tokens, self.block_size)
        out = self._live_pref_hash(khash, read=True)[: self.replication]
        old = self._old_ring
        if old is not None:
            with self._lock:
                dead = self._down | self._retired
            old_pref = [i for i in self._pref_indices(khash, old) if i not in dead]
            for i in old_pref[: self.replication]:
                if i not in out:
                    out.append(i)
        return out

    def replicas_for(self, tokens: Sequence[int]) -> List[int]:
        """The node indices a put of ``tokens`` targets right now."""
        return self._live_pref(tokens)[: self.replication]

    def mark_down(self, idx: int) -> None:
        with self._lock:
            if idx not in self._down:
                self._down.add(idx)
                self._down_since.setdefault(idx, time.monotonic())
                self.cluster_stats.marked_down += 1

    @property
    def down_nodes(self) -> List[int]:
        with self._lock:
            return sorted(self._down)

    @property
    def live_nodes(self) -> List[int]:
        with self._lock:
            return [
                i for i in range(len(self.nodes))
                if i not in self._down and i not in self._retired
            ]

    @property
    def retired_nodes(self) -> List[int]:
        with self._lock:
            return sorted(self._retired)

    def refresh_nodes(self) -> List[int]:
        """Ping every down node; revive the ones that answer.  Returns the
        revived indices.  Rejoin is a membership flip only — rings never
        rehash, so the node resumes its current arcs immediately."""
        revived = []
        with self._lock:
            down = sorted(self._down - self._retired)
        for i in down:
            if self.nodes[i].ping():
                with self._lock:
                    self._down.discard(i)
                    self._down_since.pop(i, None)
                    # membership of the live set changed: future deaths
                    # must re-trigger repair even for a previously
                    # repaired down-set
                    self._last_repaired = frozenset()
                    self.cluster_stats.revived += 1
                revived.append(i)
        return revived

    # --------------------------------------------------- elastic membership
    @property
    def in_transition(self) -> bool:
        return self._transition is not None

    def add_node(
        self,
        node: Union[RemoteKVBlockStore, Address],
        node_id: Optional[str] = None,
    ) -> int:
        """Join a node to the cluster.  Returns its index.  Writes route
        to the grown ring immediately; the migrator copies the moved arcs
        on the maintenance cadence, and reads consult both rings until it
        finishes."""
        if isinstance(node, RemoteKVBlockStore):
            client = node
        else:
            client = RemoteKVBlockStore(
                node, block_size=self.block_size, **self._client_kwargs
            )
        if client.block_size != self.block_size:
            raise ValueError(
                f"node block_size {client.block_size} != cluster {self.block_size}"
            )
        nid = node_id if node_id is not None else str(client.address)
        with self._lock:
            if nid in self._node_index:
                raise ValueError(f"duplicate node id {nid!r}")
            self.nodes.append(client)
            idx = len(self.nodes) - 1
            self._node_index[nid] = idx
        new_ring = HashRing(list(self.ring.node_ids) + [nid], vnodes=self.ring.vnodes)
        self._begin_transition(new_ring)
        return idx

    def remove_node(self, node: Union[int, str]) -> int:
        """Drain a node out of the cluster (by index or ring id).  The
        node keeps serving reads as an old-ring owner — and acts as a
        migration source — until its arcs have been copied off; then it
        is retired from routing.  Returns its index."""
        with self._lock:
            if isinstance(node, str):
                if node not in self._node_index:
                    raise ValueError(f"unknown node id {node!r}")
                nid, idx = node, self._node_index[node]
            else:
                idx = int(node)
                ids = [k for k, v in self._node_index.items() if v == idx]
                if not ids:
                    raise ValueError(f"unknown node index {idx}")
                nid = ids[0]
            if nid not in self.ring.node_ids:
                raise ValueError(f"node {nid!r} is not a ring member")
            if len(self.ring) <= 1:
                raise ValueError("cannot remove the last node")
            self._pending_retire.add(idx)
        new_ring = HashRing(
            [n for n in self.ring.node_ids if n != nid], vnodes=self.ring.vnodes
        )
        self._begin_transition(new_ring)
        return idx

    def _begin_transition(self, new_ring: HashRing) -> None:
        """Swap to ``new_ring`` and (re)start the rebalance.  A change
        arriving mid-transition folds in: the *original* ring stays the
        old/read view, so keys still un-migrated from it are never
        orphaned, and the migrator restarts against the union of moved
        arcs."""
        with self._lock:
            base = self._old_ring if self._old_ring is not None else self.ring
            self.ring = new_ring
            self.replication = max(
                1, min(self._requested_replication, len(new_ring))
            )
            self._old_ring = base
            self._transition = TransitionView(base, new_ring, self.replication)
        self.migrator.begin_rebalance(self._transition)

    def _complete_transition(self) -> None:
        """Called by the migrator when the rebalance copy has drained:
        drop the old ring and retire any removed nodes from routing."""
        with self._lock:
            self._old_ring = None
            self._transition = None
            self._retired |= self._pending_retire
            self._pending_retire = set()
            self._down -= self._retired
            for i in self._retired:
                self._down_since.pop(i, None)

    def _note_repaired(self, downset: frozenset) -> None:
        with self._lock:
            self._last_repaired = frozenset(downset)

    def migrate_step(self, max_pages: Optional[int] = None) -> dict:
        """One unit of background data movement, driven from every
        ``maintenance`` cycle.  Rebalance tasks (membership changes) are
        started by ``_begin_transition``; this is also where a death is
        noticed and a repair task launched: with R >= 2, arcs whose
        replica set includes a down node are re-copied from the survivors
        so the cluster returns to full replication."""
        if (
            not self.migrator.active
            and self._transition is None
            and self.replication >= 2
        ):
            with self._lock:
                down_members = frozenset(
                    i for i in self._down
                    if i not in self._retired and i not in self._pending_retire
                )
                already = self._last_repaired
            if down_members and down_members != already:
                ids = [
                    nid for nid, i in self._node_index.items() if i in down_members
                ]
                arcs = affected_arcs(self.ring, ids, self.replication)
                with self._lock:
                    stamps = [
                        self._down_since[i] for i in down_members
                        if i in self._down_since
                    ]
                down_t0 = min(stamps) if stamps else None
                self.migrator.begin_repair(down_members, arcs, down_t0)
        if self.migrator.active:
            return self.migrator.step(max_pages)
        return {"active": False}

    # ----------------------------------------------------- single-key ops
    def put_batch(
        self,
        tokens: Sequence[int],
        blocks: Sequence[np.ndarray],
        start_block: int = 0,
        skip_existing: bool = True,
    ) -> int:
        """Write to the first R live preference nodes; a mid-write failure
        marks the node down and slides to the next live node, so the put
        keeps R copies among survivors whenever possible."""
        written: List[int] = []
        for idx in self._live_pref(tokens):
            if len(written) >= self.replication:
                break
            try:
                written.append(
                    self.nodes[idx].put_batch(
                        tokens, blocks, start_block=start_block,
                        skip_existing=skip_existing,
                    )
                )
            except NodeUnavailable:
                self.mark_down(idx)
        if not written:
            raise NodeUnavailable("no replica accepted the write")
        return max(written)

    def probe(self, tokens: Sequence[int]) -> int:
        """Max contiguous prefix over the first R live replicas (a replica
        that was down for some writes can only under-report; max restores
        the survivors' view)."""
        best = 0
        full = (len(tokens) // self.block_size) * self.block_size
        for rank, idx in enumerate(self._read_replicas(tokens)):
            try:
                got = self.nodes[idx].probe(tokens)
            except NodeUnavailable:
                self.mark_down(idx)
                continue
            if rank > 0 and got > best:
                with self._lock:
                    self.cluster_stats.failovers += 1
            best = max(best, got)
            if best >= full:
                break
        return best

    def get_batch(self, tokens: Sequence[int], n_tokens: int) -> List[np.ndarray]:
        best: List[np.ndarray] = []
        want_blocks = n_tokens // self.block_size
        for rank, idx in enumerate(self._read_replicas(tokens)):
            try:
                got = self.nodes[idx].get_batch(tokens, n_tokens)
            except NodeUnavailable:
                self.mark_down(idx)
                continue
            if len(got) > len(best):
                if rank > 0:
                    with self._lock:
                        self.cluster_stats.failovers += 1
                best = got
            if len(best) >= want_blocks:
                break
        return best

    def get_batch_stream(self, tokens: Sequence[int], n_tokens: int) -> "ClusterBlockStream":
        """Streaming read with mid-stream failover: blocks are yielded as
        they arrive from the primary replica; if the stream breaks after
        ``k`` blocks, the next live replica resumes — blocks are
        content-addressed, so replica ``r``'s block ``k`` is bit-identical
        to the dead primary's and the stitched prefix stays exact.  A
        short stream is a short *prefix*, never a hole: the consumer
        commits exactly the blocks it received."""
        return ClusterBlockStream(self, tokens, n_tokens)

    # ------------------------------------------------------------- fan-out
    def _groups(
        self, seqs: Sequence[Sequence[int]], read: bool = False
    ) -> Dict[Tuple[int, ...], List[int]]:
        """Positions grouped by their current replica tuple; one group =
        one batched RPC per replica node.  Reads go through the
        transition-aware replica set so in-flight migrations never hide
        a key."""
        groups: Dict[Tuple[int, ...], List[int]] = {}
        for pos, tokens in enumerate(seqs):
            if read:
                key = tuple(self._read_replicas(tokens))
            else:
                key = tuple(self._live_pref(tokens)[: self.replication])
            groups.setdefault(key, []).append(pos)
        return groups

    def _run_groups(self, groups, task) -> None:
        """Run ``task(replicas, positions)`` for every group, in parallel
        on the executor when one is attached: one batched RPC per node
        per group.  Keeping whole groups in single round trips beats
        chunking them across pooled connections — per-RPC costs (frame
        handling, executor handoff, syscalls) outweigh the intra-node
        pipelining that smaller chunks would buy."""
        items = list(groups.items())
        if self._executor is not None and len(items) > 1:
            self._executor.map_parallel(lambda kv: task(kv[0], kv[1]), items)
            return
        for replicas, positions in items:
            task(replicas, positions)

    def probe_many(self, seqs: Sequence[Sequence[int]]) -> List[int]:
        out = [0] * len(seqs)

        def task(replicas: Tuple[int, ...], positions: List[int]) -> None:
            batch = [seqs[p] for p in positions]
            answered = False
            for rank, idx in enumerate(replicas):
                try:
                    res = self.nodes[idx].probe_many(batch)
                except NodeUnavailable:
                    self.mark_down(idx)
                    continue
                for p, got in zip(positions, res):
                    if rank > 0 and got > out[p]:
                        with self._lock:
                            self.cluster_stats.failovers += 1
                    out[p] = max(out[p], got)
                answered = True
            if not answered:  # whole replica tuple went down: re-route
                for p in positions:
                    out[p] = self.probe(seqs[p])

        self._run_groups(self._groups(seqs, read=True), task)
        return out

    def get_many(
        self, items: Sequence[Tuple[Sequence[int], int]]
    ) -> List[List[np.ndarray]]:
        out: List[List[np.ndarray]] = [[] for _ in items]

        def task(replicas: Tuple[int, ...], positions: List[int]) -> None:
            pending = list(positions)
            for rank, idx in enumerate(replicas):
                if not pending:
                    return
                batch = [(items[p][0], items[p][1]) for p in pending]
                try:
                    res = self.nodes[idx].get_many(batch)
                except NodeUnavailable:
                    self.mark_down(idx)
                    continue
                still = []
                for p, got in zip(pending, res):
                    if len(got) > len(out[p]):
                        if rank > 0:
                            with self._lock:
                                self.cluster_stats.failovers += 1
                        out[p] = got
                    if len(out[p]) < items[p][1] // self.block_size:
                        still.append(p)  # deficient: ask the next replica
                pending = still
            for p in pending:  # replica tuple exhausted: re-route fully
                got = self.get_batch(items[p][0], items[p][1])
                if len(got) > len(out[p]):
                    out[p] = got

        self._run_groups(self._groups([t for t, _ in items], read=True), task)
        return out

    def put_many(
        self, items: Sequence[Tuple[Sequence[int], Sequence[np.ndarray], int]]
    ) -> List[int]:
        out = [0] * len(items)

        def task(replicas: Tuple[int, ...], positions: List[int]) -> None:
            batch = [items[p] for p in positions]
            successes = 0
            for idx in replicas:
                try:
                    res = self.nodes[idx].put_many(batch)
                except NodeUnavailable:
                    self.mark_down(idx)
                    continue
                for p, wrote in zip(positions, res):
                    out[p] = max(out[p], wrote)
                successes += 1
            if successes < self.replication and len(self.live_nodes) > successes:
                # a replica died mid-batch: slide to the next live
                # preference nodes (put_batch recomputes them; surviving
                # copies dedup via skip_existing) so the batch keeps R
                # copies among survivors — same contract as put_batch
                for p in positions:
                    t, bs, s = items[p]
                    out[p] = max(out[p], self.put_batch(t, bs, start_block=s))

        self._run_groups(self._groups([t for t, _, _ in items]), task)
        return out

    # ---------------------------------------------------------- maintenance
    def maintenance(self, compact_steps: int = 8) -> dict:
        """Fan one maintenance cycle out to every live node (parallel when
        an executor is attached) and piggyback down-node rejoin checks —
        the cadence the serving engine already drives.

        Ordering matters: migration runs *before* the per-node fan-out so
        freshly copied blocks land at their destinations before those
        nodes enforce their budgets (a block is never evicted in the same
        cycle it arrives), and a source cannot evict-then-copy within one
        cycle."""
        revived = self.refresh_nodes()
        mig = self.migrate_step()
        live = self.live_nodes
        rep: dict = {"compactions": 0, "nodes": {}, "revived": revived,
                     "down": self.down_nodes, "migration": mig}

        def one(i: int) -> Optional[dict]:
            try:
                return self.nodes[i].maintenance(compact_steps)
            except NodeUnavailable:
                self.mark_down(i)
                return None

        if self._executor is not None and len(live) > 1:
            reports = self._executor.map_parallel(one, live)
        else:
            reports = [one(i) for i in live]
        for i, nrep in zip(live, reports):
            if nrep is None:
                continue
            rep["nodes"][i] = nrep
            rep["compactions"] += nrep.get("compactions", 0)
        return rep

    # ------------------------------------------------------------ lifecycle
    def flush(self) -> None:
        for i in self.live_nodes:
            try:
                self.nodes[i].flush()
            except NodeUnavailable:
                self.mark_down(i)

    def close(self) -> None:
        """Close the client connections; node processes are owned by their
        spawner and stay up."""
        if self._owns_executor and self._executor is not None:
            self._executor.close()
        for c in self.nodes:
            c.close()
        if self._mux_loop is not None:
            self._mux_loop.close()

    # ---------------------------------------------------------------- stats
    def _sum_live(self, attr: str) -> int:
        total = 0
        for i in self.live_nodes:
            try:
                total += getattr(self.nodes[i], attr)
            except NodeUnavailable:
                self.mark_down(i)
        return total

    @property
    def stats(self) -> StoreStats:
        parts = []
        for i in self.live_nodes:
            try:
                parts.append(self.nodes[i].stats)
            except NodeUnavailable:
                self.mark_down(i)
        return merge_stats(parts)

    @property
    def disk_bytes(self) -> int:
        return self._sum_live("disk_bytes")

    @property
    def file_count(self) -> int:
        return self._sum_live("file_count")

    def node_reports(self) -> Dict[int, dict]:
        """Raw per-node reports — backend stats, server transport
        counters, and this side's client transport view.  Unreachable
        nodes are marked down and omitted."""
        out: Dict[int, dict] = {}
        for i in self.live_nodes:
            try:
                out[i] = self.nodes[i].node_report()
            except NodeUnavailable:
                self.mark_down(i)
        return out

    def report(self, include_nodes: bool = True) -> dict:
        """Cluster-level telemetry: membership, failover counters, the
        per-client transport stats, and (by default) a compact per-node
        backend/server summary aggregated from each node's STATS."""
        rep = {
            "n_nodes": len(self.nodes),
            "replication": self.replication,
            "live": self.live_nodes,
            "down": self.down_nodes,
            "retired": self.retired_nodes,
            "in_transition": self.in_transition,
            "cluster": self.cluster_stats.as_dict(),
            "migration": self.migrator.stats.as_dict(),
            "rpc": {i: c.rpc_stats.as_dict() for i, c in enumerate(self.nodes)},
        }
        if include_nodes:
            nodes = {}
            for i, nrep in self.node_reports().items():
                st, srv = nrep.get("stats", {}), nrep.get("server", {})
                nodes[i] = {
                    "name": nrep.get("name"),
                    "disk_bytes": nrep.get("disk_bytes"),
                    "file_count": nrep.get("file_count"),
                    "get_blocks": st.get("get_blocks"),
                    "put_blocks": st.get("put_blocks"),
                    "raw_gets": st.get("raw_gets"),
                    "streams": srv.get("streams"),
                    "stream_chunks": srv.get("stream_chunks"),
                    "sendfile_bytes": srv.get("sendfile_bytes"),
                }
            rep["nodes"] = nodes
        return rep

    def scrape_cluster(self) -> dict:
        """One aggregated metrics scrape of the whole cluster.

        Every node contributes its full ``OP_METRICS`` snapshot
        (counters, gauges, latency histograms, recent traces).  A node
        that cannot be reached is *reported*, never waited on past the
        client timeout: already-down nodes are skipped without an RPC,
        and a node that fails mid-scrape is marked down and recorded as
        ``{"unreachable": True, "error": ...}`` — the scrape itself
        always succeeds.  The client-side view (routing + transport
        registry) rides along under ``"cluster"``."""
        nodes: Dict[int, dict] = {}
        down = set(self.down_nodes)
        retired = set(self.retired_nodes)
        for i, client in enumerate(self.nodes):
            if i in retired:
                nodes[i] = {"retired": True}
                continue
            if i in down:
                nodes[i] = {"unreachable": True, "error": "marked down"}
                continue
            try:
                nodes[i] = client.metrics()
            except NodeUnavailable as e:
                self.mark_down(i)
                nodes[i] = {"unreachable": True, "error": str(e)}
        return {
            "nodes": nodes,
            "live": self.live_nodes,
            "down": self.down_nodes,
            "retired": self.retired_nodes,
            "cluster": self.registry.snapshot(),
        }


class ClusterBlockStream:
    """Iterator over one sequence's blocks, stitched across replicas on
    mid-stream failure.  ``first_block_s`` is time-to-first-block from
    construction; ``served`` counts blocks yielded; ``failovers`` counts
    replica switches that contributed blocks."""

    def __init__(self, store: ClusterKVBlockStore, tokens: Sequence[int], n_tokens: int):
        self._store = store
        self._tokens = list(tokens)
        self._n_tokens = int(n_tokens)
        self._t0 = time.perf_counter()
        self.first_block_s: Optional[float] = None
        self.served = 0
        self.failovers = 0

    def __iter__(self) -> Iterator[np.ndarray]:
        store = self._store
        want = self._n_tokens // store.block_size
        if want == 0:
            return
        replicas = store._read_replicas(self._tokens)
        for rank, idx in enumerate(replicas):
            if self.served >= want:
                return
            contributed = False
            try:
                node_stream = store.nodes[idx].get_batch_stream(
                    self._tokens, self._n_tokens
                )
                # a later replica re-streams from block 0; skip what was
                # already yielded (content addressing: identical bytes)
                skip = self.served
                for b in node_stream:
                    if skip:
                        skip -= 1
                        continue
                    if rank > 0 and not contributed:
                        contributed = True
                        self.failovers += 1
                        with store._lock:
                            store.cluster_stats.failovers += 1
                    if self.first_block_s is None:
                        self.first_block_s = time.perf_counter() - self._t0
                    self.served += 1
                    yield b
                if self.served >= want:
                    return
                # clean but short: a cold replica may still extend the run
            except NodeUnavailable:
                store.mark_down(idx)
                continue
        # replicas exhausted: the stream ends as a (possibly short) prefix
