"""Background block migration and replica repair for the cache cluster.

``BlockMigrator`` is the data-movement half of elastic membership: when
the cluster store swaps rings (``add_node`` / ``remove_node``) or a death
leaves key ranges at R-1 surviving copies, the migrator copies exactly
the affected ring arcs onto their new/surviving owners.  It runs on the
**maintenance cadence** — every ``ClusterKVBlockStore.maintenance`` cycle
drives one ``step`` — so movement is deterministic, caller-scheduled
work, never a background thread (the same scheduling contract as every
other maintenance job in the repo).

One step walks each live source node's keyspace in pages through the
arc-filtered ``OP_SCAN`` RPC, pulls the matching records **in their
stored encoding** (``OP_PULL`` — an int8+zlib cold block crosses the
wire compressed), and pushes them to the key's current owners
(``OP_PUSH``).  Safety comes from idempotence, not coordination:

* every record push dedups on the receiving node (``skip_existing``), so
  retries, overlapping repair rounds, and replica sources re-offering
  the same block never double-count — ``blocks_copied`` counts blocks
  actually written;
* sources are never deleted from: the cluster is a cache, and the
  source's copy ages out through its own budget eviction.  A migration
  interrupted anywhere (including SIGKILL of either end) therefore
  loses nothing that was committed — the transition view keeps reads
  consulting old owners until the copy provably drained;
* a node death mid-step just marks the node down and moves on; the
  surviving sources' scans still cover every key that has a surviving
  copy (replicas hold the same arcs).

Completion: when every live source has exhausted its arc scan, a
rebalance task promotes the new ring (the store drops its transition
view) and a repair task records the down-set as repaired.  Per-task wall
times land in ``MigrationStats`` (``rebalance_s`` — time-to-rebalance —
and ``repair_lag_s``, measured from when the dead node was first marked
down), bridged into the cluster registry as ``repro_migration_*``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from .client import NodeUnavailable
from .ring import TransitionView, raw_key_hash


@dataclass
class MigrationStats:
    """Counters for cluster data movement (``repro_migration_*`` gauges).

    ``blocks_copied`` is exact (import-side dedup); ``bytes_moved``
    counts stored-encoding payload bytes offered over the wire, i.e. the
    network cost of the movement.  The ``*_s`` fields hold the most
    recent completed task's wall times.
    """

    migrations_started: int = 0
    migrations_completed: int = 0
    repairs_started: int = 0
    repairs_completed: int = 0
    rounds: int = 0  # migrator steps that had an active task
    keys_scanned: int = 0  # arc-matching keys returned by source scans
    blocks_pulled: int = 0  # records exported from sources
    blocks_copied: int = 0  # records actually written at destinations
    repair_blocks: int = 0  # subset of blocks_copied written by repair tasks
    bytes_moved: int = 0  # stored-encoding payload bytes shipped
    rebalance_s: float = 0.0  # wall time of the last completed rebalance
    repair_s: float = 0.0  # wall time of the last completed repair
    repair_lag_s: float = 0.0  # last repair: death detection -> full R copies

    def as_dict(self) -> dict:
        return dict(self.__dict__)


@dataclass
class _Task:
    kind: str  # "rebalance" | "repair"
    arcs: List[Tuple[int, int]]
    t0: float
    cursors: Dict[int, bytes] = field(default_factory=dict)
    exhausted: Set[int] = field(default_factory=set)
    down_t0: Optional[float] = None  # earliest mark-down of the repaired set
    target_down: FrozenSet[int] = frozenset()


class BlockMigrator:
    """Drives arc copies for one ``ClusterKVBlockStore``.

    At most one task is active at a time; a membership change during a
    repair supersedes it (the repair re-triggers afterwards — the store
    only records a down-set as repaired when its task completes).
    """

    def __init__(self, store, page_keys: int = 512):
        self.store = store
        self.page_keys = max(1, int(page_keys))
        self.stats = MigrationStats()
        self._task: Optional[_Task] = None

    @property
    def active(self) -> bool:
        return self._task is not None

    @property
    def task_kind(self) -> Optional[str]:
        return self._task.kind if self._task is not None else None

    # ------------------------------------------------------------- lifecycle
    def begin_rebalance(self, view: TransitionView) -> None:
        """Start (or restart, folding in a further membership change)
        copying the transition view's moved arcs.  Every live node is a
        source — replicas and previously-added nodes may hold moved keys
        too, and an empty node's scan costs one RPC."""
        self._task = _Task(kind="rebalance", arcs=list(view.moved), t0=time.monotonic())
        with self.store._lock:
            self.stats.migrations_started += 1

    def begin_repair(
        self,
        down: FrozenSet[int],
        arcs: List[Tuple[int, int]],
        down_t0: Optional[float],
    ) -> None:
        """Re-replicate ``arcs`` (the ranges whose R-replica set includes a
        node in ``down``) from the surviving copies onto the keys' live
        owners, restoring R copies."""
        self._task = _Task(
            kind="repair", arcs=list(arcs), t0=time.monotonic(),
            down_t0=down_t0, target_down=frozenset(down),
        )
        with self.store._lock:
            self.stats.repairs_started += 1

    # ------------------------------------------------------------------ step
    def step(self, max_pages: Optional[int] = None) -> dict:
        """Advance the active task.  By default a step drains the task to
        completion (bounded by a generous page cap), so the acceptance
        cadence — rebalance finishes within one maintenance cycle —
        holds; pass a small ``max_pages`` to move incrementally (the
        fault-injection tests do, to kill nodes mid-migration)."""
        task = self._task
        if task is None:
            return {"active": False}
        st = self.store
        budget = 100_000 if max_pages is None else max(1, int(max_pages))
        pages = copied = 0
        with st._lock:
            self.stats.rounds += 1
        if task.arcs:
            for src in list(st.live_nodes):
                if src in task.exhausted or pages >= budget:
                    continue
                while pages < budget:
                    try:
                        keys, nxt = st.nodes[src].scan_keys(
                            task.cursors.get(src), self.page_keys, ranges=task.arcs
                        )
                    except NodeUnavailable:
                        st.mark_down(src)
                        break
                    pages += 1
                    with st._lock:
                        self.stats.keys_scanned += len(keys)
                    if keys:
                        copied += self._copy(src, keys, task)
                    if nxt is None:
                        task.exhausted.add(src)
                        task.cursors.pop(src, None)
                        break
                    task.cursors[src] = nxt
        else:
            task.exhausted.update(st.live_nodes)
        done = all(i in task.exhausted for i in st.live_nodes)
        if done:
            self._finish(task)
        return {
            "active": self._task is not None,
            "kind": task.kind,
            "pages": pages,
            "copied": copied,
            "done": done,
        }

    # ------------------------------------------------------------ internals
    def _dests(self, khash: int, exclude: int) -> List[int]:
        """The key's first R live owners under the *target* ring, minus
        the source (which already holds the block)."""
        st = self.store
        pref = st._pref_indices(khash)
        with st._lock:
            dead = st._down | st._retired
        live = [i for i in pref if i not in dead]
        return [i for i in live[: st.replication] if i != exclude]

    def _copy(self, src: int, keys: List[bytes], task: _Task) -> int:
        st = self.store
        try:
            recs = st.nodes[src].export_encoded(keys)
        except NodeUnavailable:
            st.mark_down(src)
            return 0
        by_dest: Dict[int, list] = {}
        pulled = 0
        for key, rec in zip(keys, recs):
            if rec is None:
                continue  # key aged out between scan and pull — cache semantics
            pulled += 1
            flags, payload = rec
            khash = raw_key_hash(key, st.block_size)
            for dest in self._dests(khash, exclude=src):
                by_dest.setdefault(dest, []).append((key, flags, payload))
        written = 0
        offered_bytes = 0
        for dest, records in by_dest.items():
            try:
                n = st.nodes[dest].import_encoded(records, skip_existing=True)
            except NodeUnavailable:
                st.mark_down(dest)
                continue
            written += n
            offered_bytes += sum(len(p) for _, _, p in records)
        with st._lock:
            self.stats.blocks_pulled += pulled
            self.stats.blocks_copied += written
            self.stats.bytes_moved += offered_bytes
            if task.kind == "repair":
                self.stats.repair_blocks += written
        return written

    def _finish(self, task: _Task) -> None:
        now = time.monotonic()
        st = self.store
        self._task = None
        if task.kind == "rebalance":
            st._complete_transition()
            with st._lock:
                self.stats.migrations_completed += 1
                self.stats.rebalance_s = now - task.t0
        else:
            st._note_repaired(task.target_down)
            with st._lock:
                self.stats.repairs_completed += 1
                self.stats.repair_s = now - task.t0
                if task.down_t0 is not None:
                    self.stats.repair_lag_s = now - task.down_t0
