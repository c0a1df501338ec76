"""Hierarchical KV-cache manager: radix tree + device/host memory tiers +
a pluggable disk backend (any ``repro.core.backend.StorageBackend``:
``KVBlockStore``, ``ShardedKVBlockStore``, or one of the paper's
baselines).  This layer depends only on the protocol — backend choice is
a constructor argument.

This is the integration point the paper describes in §3.2: the in-memory
radix tree and RadixAttention logic are preserved; only the disk backend
behind it is swapped.  ``acquire`` implements the longest-prefix reuse path
(radix match, then a disk ``probe`` to extend the match, then ``get_batch``
promotion), and ``commit`` implements write-through population.

``acquire`` is factored into three phases so the serving engine can
pipeline them (paper §3.4 batch operations):

    plan(tokens)    -> AcquirePlan   radix match only; engine thread
    fetch(plan)     -> DiskFetch     backend probe + batched get_batch;
                                     touches ONLY the (thread-safe) store,
                                     so it can run on an I/O executor while
                                     the engine computes the previous batch
    fulfill(plan, fetch) -> Acquisition   install/promote; engine thread

``acquire`` = plan → fetch → fulfill, so the serial path is the same code.
``fulfill`` re-matches the radix tree rather than trusting the plan — a
batch committed between plan and fulfill may have grown the tree, and a
prefetch must never install stale state.

Compression tiers are invisible here: a block demoted to int8 or
int8+zlib (``core.tiering``) travels still-encoded through the store and
over the cluster wire (``LAYOUT_ENCODED`` / vlog chunks) and is decoded
at the fulfill boundary — locally by ``get_batch``, remotely by the
client's chunk decode as ``_StreamedBlocks`` drains — so ``fulfill``
always installs dense tensors and never sees a codec tag.  With a
streamed fetch that decode is lazy: a cold block still on the wire is
not decompressed until ``fulfill`` asks for its index.

``commit`` installs into device memory on the engine thread and, when a
``CommitQueue`` is attached, hands the disk write-through to the
write-behind drain thread instead of charging it to the request.
The radix tree itself is single-threaded by design: only the engine thread
ever mutates it (fetch closures capture token lists, never nodes).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.backend import StorageBackend
from ..obs.tracing import maybe_span
from ..runtime.writebehind import CommitQueue
from .radix import (
    TIER_DEVICE,
    TIER_DISK,
    TIER_HOST,
    TIER_NONE,
    RadixNode,
    RadixTree,
)


@dataclass
class CacheStats:
    requests: int = 0
    tokens_requested: int = 0
    tokens_hit_device: int = 0
    tokens_hit_host: int = 0
    tokens_hit_disk: int = 0
    tokens_missed: int = 0
    promote_s: float = 0.0  # disk -> memory I/O time
    streamed_fetches: int = 0  # fetches served over a streaming backend
    first_block_s: float = 0.0  # summed time-to-first-block of those fetches
    demotions: int = 0
    drops: int = 0
    writeback_blocks: int = 0  # commits handed to the write-behind queue
    plan_stale: int = 0  # prefetch plans that fulfill found outdated

    @property
    def hit_rate(self) -> float:
        hit = self.tokens_hit_device + self.tokens_hit_host + self.tokens_hit_disk
        return hit / max(1, self.tokens_requested)


@dataclass
class Acquisition:
    nodes: List[RadixNode]
    reuse_tokens: int  # tokens whose KV is now device-resident
    device_tokens: int
    host_tokens: int
    disk_tokens: int
    io_s: float  # measured promotion I/O time


@dataclass
class AcquirePlan:
    """Phase 1 of acquire: what the radix tree knew at plan time.  Carries
    only token lists and counts — never tree nodes — so the fetch phase can
    run on another thread without touching shared tree state."""

    tokens: List[int]
    chain_blocks: int  # radix-matched blocks at plan time
    disk_chain_depth: int  # deepest matched node whose data lives only on disk
    total_blocks: int

    @property
    def need_disk(self) -> bool:
        return self.disk_chain_depth > 0 or self.chain_blocks < self.total_blocks


@dataclass
class DiskFetch:
    """Phase 2 result: the contiguous disk prefix (blocks from index 0).

    ``blocks`` is either a plain list or a lazy ``_StreamedBlocks`` whose
    tail is still on the wire; ``fulfill`` touches it only through
    ascending indices and slices, so streamed blocks are consumed in
    arrival order.  ``first_block_s`` is the fetch-relative
    time-to-first-block (None when the backend doesn't stream or the
    fetch was empty)."""

    probed_tokens: int = 0
    blocks: Sequence[np.ndarray] = field(default_factory=list)
    io_s: float = 0.0
    first_block_s: Optional[float] = None


class _StreamedBlocks:
    """List-shaped view over a streaming get: blocks materialize as the
    wire delivers them, and indexing drains the stream only as far as
    asked — so ``fulfill`` installs block 0 while blocks 1..N are still
    in flight.  A transport failure mid-stream truncates the sequence
    (the hierarchy already treats a short disk read as a shorter hit);
    it never raises into the tree-mutation path."""

    def __init__(self, stream):
        self._it = iter(stream)
        self._got: List[np.ndarray] = []
        self._done = False

    def _pull_to(self, n: int) -> None:
        while not self._done and len(self._got) < n:
            try:
                blk = next(self._it)
            except StopIteration:
                self._done = True
            except (ConnectionError, OSError):
                self._done = True  # replicas exhausted: keep the prefix
            else:
                self._got.append(blk)

    def prime(self) -> bool:
        """Pull block 0 (the time-to-first-block moment)."""
        self._pull_to(1)
        return bool(self._got)

    def close(self) -> None:
        """Abort without draining — the consumer took what it needed;
        chunks still in flight are dropped by the transport."""
        self._done = True
        close = getattr(self._it, "close", None)
        if close is not None:
            close()

    def __len__(self) -> int:
        self._pull_to(1 << 62)
        return len(self._got)

    def __getitem__(self, i):
        if isinstance(i, slice):
            if i.stop is None or i.stop < 0 or (i.start or 0) < 0 or i.step not in (None, 1):
                self._pull_to(1 << 62)
            else:
                self._pull_to(i.stop)
            return self._got[i]
        if i < 0:
            self._pull_to(1 << 62)
        else:
            self._pull_to(i + 1)
        return self._got[i]


def _block_at(blocks: Sequence[np.ndarray], i: int) -> Optional[np.ndarray]:
    """``blocks[i]`` or None — without forcing a lazy sequence to drain
    to its end just to answer a bounds check."""
    if i < 0:
        return None
    try:
        return blocks[i]
    except IndexError:
        return None


class CacheHierarchy:
    def __init__(
        self,
        block_size: int,
        device_budget_blocks: int,
        host_budget_blocks: int,
        store: Optional[StorageBackend] = None,  # disk backend, or None (memory-only)
        write_through: bool = True,
        commit_queue: Optional[CommitQueue] = None,  # write-behind; None = inline
    ):
        self.tree = RadixTree(block_size)
        self.block_size = block_size
        self.device_budget = device_budget_blocks
        self.host_budget = host_budget_blocks
        self.store = store
        self.write_through = write_through
        self.commit_queue = commit_queue
        self.device_blocks = 0
        self.host_blocks = 0
        self.stats = CacheStats()

    # ------------------------------------------------------------ internals
    def _make_room(self, tier: int, need: int) -> None:
        """Demote LRU leaves until `need` blocks fit in `tier`."""
        if tier == TIER_DEVICE:
            budget, used = self.device_budget, self.device_blocks
        else:
            budget, used = self.host_budget, self.host_blocks
        overflow = used + need - budget
        while overflow > 0:
            leaves = self.tree.evictable_leaves(tier)
            if not leaves:
                break  # everything locked: admit over budget rather than stall
            # demote as many of this frontier as needed, then re-derive the
            # frontier (parents become evictable once children leave)
            for leaf in leaves[:overflow]:
                self._demote(leaf)
            overflow -= min(overflow, len(leaves))

    def _demote(self, node: RadixNode) -> None:
        if node.tier == TIER_DEVICE:
            self._make_room(TIER_HOST, 1)
            if self.host_blocks < self.host_budget:
                node.tier = TIER_HOST
                self.host_blocks += 1
            else:
                self._spill_to_disk(node)
            self.device_blocks -= 1
            self.stats.demotions += 1
        elif node.tier == TIER_HOST:
            self._spill_to_disk(node)
            self.host_blocks -= 1
            self.stats.demotions += 1

    def _spill_to_disk(self, node: RadixNode) -> None:
        if self.store is not None and not node.on_disk and node.data is not None:
            tokens = self._path_tokens(node)
            self.store.put_batch(tokens, [node.data], start_block=node.depth - 1)
            node.on_disk = True
        node.data = None
        if self.store is not None and node.on_disk:
            node.tier = TIER_DISK
        else:
            # no disk backend: block is lost (the memory-only baseline)
            node.tier = TIER_NONE
            self.stats.drops += 1
            self.tree.drop(node)

    @staticmethod
    def _path_tokens(node: RadixNode) -> List[int]:
        toks: List[int] = []
        chain = []
        cur = node
        while cur is not None and cur.parent is not None:
            chain.append(cur)
            cur = cur.parent
        for n in reversed(chain):
            toks.extend(n.block)
        return toks

    # ---------------------------------------------------------------- acquire
    def plan(self, tokens: Sequence[int]) -> AcquirePlan:
        """Phase 1 (engine thread): radix match; decide what disk I/O the
        fetch phase should issue.  Does not lock or mutate tier state."""
        with maybe_span("plan"):
            B = self.block_size
            chain = self.tree.match_prefix(tokens)
            disk_depth = max((n.depth for n in chain if n.tier == TIER_DISK), default=0)
            return AcquirePlan(
                tokens=list(tokens),
                chain_blocks=len(chain),
                disk_chain_depth=disk_depth,
                total_blocks=len(tokens) // B,
            )

    def fetch(self, plan: AcquirePlan) -> DiskFetch:
        """Phase 2 (any thread): backend probe + one batched get covering
        both the disk extension beyond the radix chain and the chain nodes
        whose payloads live only on disk.  Touches nothing but the
        thread-safe store.

        On a streaming backend (one exposing ``get_batch_stream``) this
        returns as soon as block 0 is on hand: the tail keeps arriving
        off the wire while ``fulfill`` installs the early blocks, and
        ``first_block_s`` records the time-to-first-block the serving
        layer reports.  ``io_s`` then covers only the streamed prefix —
        the drain happens under ``fulfill``'s own clock."""
        with maybe_span("fetch"):
            return self._fetch(plan)

    def _fetch(self, plan: AcquirePlan) -> DiskFetch:
        if self.store is None or not plan.need_disk:
            return DiskFetch()
        B = self.block_size
        t0 = time.perf_counter()
        probed = 0
        if plan.chain_blocks < plan.total_blocks:
            probed = self.store.probe(plan.tokens)
        upto = max(probed, plan.disk_chain_depth * B)
        if not upto:
            return DiskFetch(io_s=time.perf_counter() - t0)
        stream_fn = getattr(self.store, "get_batch_stream", None)
        if stream_fn is None:
            blocks = self.store.get_batch(plan.tokens, upto)
            return DiskFetch(
                probed_tokens=probed, blocks=blocks, io_s=time.perf_counter() - t0
            )
        try:
            streamed = _StreamedBlocks(stream_fn(plan.tokens, upto))
        except (ConnectionError, OSError):
            return DiskFetch(probed_tokens=probed, io_s=time.perf_counter() - t0)
        first = streamed.prime()  # block 0 lands here; the rest stays in flight
        now = time.perf_counter()
        return DiskFetch(
            probed_tokens=probed,
            blocks=streamed,
            io_s=now - t0,
            first_block_s=(now - t0) if first else None,
        )

    def fulfill(self, plan: AcquirePlan, fetched: Optional[DiskFetch] = None) -> Acquisition:
        """Phase 3 (engine thread): install fetched blocks and promote the
        usable chain to the device tier.  Re-matches the tree — commits that
        landed between plan and fulfill are honored, and fetched blocks are
        only used where they still extend the (fresh) chain.  The returned
        node path is locked until ``release``."""
        with maybe_span("fulfill"):
            return self._fulfill(plan, fetched)

    def _fulfill(self, plan: AcquirePlan, fetched: Optional[DiskFetch] = None) -> Acquisition:
        B = self.block_size
        tokens = plan.tokens
        fetched = fetched or DiskFetch()
        self.stats.requests += 1
        self.stats.tokens_requested += len(tokens)
        t0 = time.perf_counter()
        chain = self.tree.match_prefix(tokens)
        if len(chain) != plan.chain_blocks:
            self.stats.plan_stale += 1
        dev = host = disk = 0

        # classify memory-resident part
        for n in chain:
            if n.tier == TIER_DEVICE:
                dev += 1
            elif n.tier == TIER_HOST:
                host += 1
            elif n.tier == TIER_DISK:
                disk += 1

        # promote disk-resident chain nodes first, in ascending depth: on
        # a streamed fetch these are the earliest blocks off the wire, so
        # installation starts while the extension is still in flight
        for n in chain:
            if n.tier != TIER_DISK:
                continue
            blk = _block_at(fetched.blocks, n.depth - 1)
            if blk is not None:
                n.data = blk
            else:  # disk lost it (eviction) or the plan predates it: miss
                n.tier = TIER_NONE
                disk -= 1

        # extend the match past the in-memory chain with fetched disk
        # blocks (this slice drains the rest of a streamed fetch)
        disk_ext_blocks: List[np.ndarray] = []
        if fetched.probed_tokens > len(chain) * B:
            disk_ext_blocks = list(fetched.blocks[len(chain) :])
            disk += len(disk_ext_blocks)
        abort = getattr(fetched.blocks, "close", None)
        if abort is not None:
            abort()  # drop any streamed blocks fulfill didn't need

        # materialize the full usable chain on device
        nodes = list(chain)
        if disk_ext_blocks:
            ext_tokens = tokens[: (len(chain) + len(disk_ext_blocks)) * B]
            new_nodes = self.tree.insert_path(ext_tokens)[len(chain) :]
            for n, blk in zip(new_nodes, disk_ext_blocks):
                n.data = blk
                n.tier = TIER_HOST  # staged; promoted below
                n.on_disk = True
                self.host_blocks += 1
            nodes.extend(new_nodes)

        # cut the chain at the first unusable node
        usable: List[RadixNode] = []
        for n in nodes:
            if n.tier in (TIER_DEVICE, TIER_HOST) or (n.tier == TIER_DISK and n.data is not None):
                usable.append(n)
            else:
                break
        promote = [n for n in usable if n.tier != TIER_DEVICE]
        self._make_room(TIER_DEVICE, len(promote))
        for n in promote:
            if n.tier == TIER_HOST:
                self.host_blocks -= 1
            n.tier = TIER_DEVICE
            self.device_blocks += 1
        self.tree.lock_path(usable)

        io_s = fetched.io_s + (time.perf_counter() - t0)
        self.stats.promote_s += io_s
        if fetched.first_block_s is not None:
            self.stats.streamed_fetches += 1
            self.stats.first_block_s += fetched.first_block_s
        reuse = len(usable) * B
        self.stats.tokens_hit_device += dev * B
        self.stats.tokens_hit_host += host * B
        self.stats.tokens_hit_disk += disk * B
        self.stats.tokens_missed += max(0, len(tokens) - reuse)
        return Acquisition(
            nodes=usable,
            reuse_tokens=reuse,
            device_tokens=dev * B,
            host_tokens=host * B,
            disk_tokens=disk * B,
            io_s=io_s,
        )

    def acquire(self, tokens: Sequence[int]) -> Acquisition:
        """Longest-prefix reuse: radix match, disk-probe extension, and
        promotion of every matched block to the device tier — the serial
        composition of plan → fetch → fulfill.  The returned node path is
        locked until ``release``."""
        p = self.plan(tokens)
        return self.fulfill(p, self.fetch(p))

    # ----------------------------------------------------------------- commit
    def commit(self, tokens: Sequence[int], new_blocks: List[np.ndarray], acq: Acquisition) -> None:
        """Install freshly computed KV blocks (covering tokens beyond
        ``acq.reuse_tokens``) into the device tier, then populate the disk
        tier — inline write-through, or via the write-behind queue when one
        is attached (the request no longer pays the disk write)."""
        B = self.block_size
        start_block = acq.reuse_tokens // B
        total_blocks = len(tokens) // B
        n_new = min(len(new_blocks), total_blocks - start_block)
        if n_new <= 0:
            return
        self._make_room(TIER_DEVICE, n_new)
        path = self.tree.insert_path(tokens[: (start_block + n_new) * B])
        fresh = path[start_block:]
        for n, blk in zip(fresh, new_blocks):
            if n.tier == TIER_DEVICE:
                continue
            n.data = blk
            n.tier = TIER_DEVICE
            self.device_blocks += 1
        if self.write_through and self.store is not None:
            if self.commit_queue is not None:
                # write-behind: capture plain values (token list + arrays),
                # never tree nodes' mutable state.  ``on_disk`` is set at
                # enqueue time — the queue holds the payloads by reference
                # and owns the write, so a later demotion must not re-encode
                # the same blocks synchronously on the engine thread.  Known
                # window: a fetch racing the bounded queue can miss a block
                # whose write is still queued and transiently treat it as a
                # cache miss (recomputed, never corrupted); a failed
                # write-behind surfaces on the next flush/drain (the
                # standard write-back cache durability contract).
                toks = list(tokens[: (start_block + n_new) * B])
                blocks = [np.asarray(b) for b in new_blocks[:n_new]]
                store = self.store
                for n in fresh:
                    n.on_disk = True
                self.commit_queue.submit(
                    lambda: store.put_batch(toks, blocks, start_block=start_block),
                    nbytes=sum(b.nbytes for b in blocks),
                )
                self.stats.writeback_blocks += n_new
            else:
                self.store.put_batch(tokens, new_blocks[:n_new], start_block=start_block)
                for n in fresh:
                    n.on_disk = True

    def release(self, acq: Acquisition) -> None:
        self.tree.unlock_path(acq.nodes)

    # ----------------------------------------------------------------- misc
    def maintenance(self) -> dict:
        if self.store is not None:
            return self.store.maintenance()
        return {}

    @property
    def hit_rate(self) -> float:
        return self.stats.hit_rate
