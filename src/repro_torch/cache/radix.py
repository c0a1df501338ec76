"""In-memory radix tree over token-block prefixes (RadixAttention-style,
paper §2.1).  Nodes are block-granular — one node per ``block_size`` tokens —
which matches the storage engine's block keys exactly, so a tree path maps
1:1 onto a run of LSM index keys.  (SGLang's byte-granular edge splitting is
unnecessary at block granularity; noted in DESIGN.md.)

Each node records which tier currently holds its KV block (DEVICE / HOST /
DISK / NONE) and an LRU timestamp; eviction walks unlocked leaves in LRU
order, demoting device→host→disk, exactly the hierarchy of §2.1.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

TIER_DEVICE = 2
TIER_HOST = 1
TIER_DISK = 0  # present on disk only (data evicted from memory tiers)
TIER_NONE = -1  # metadata-only node (data lost / never stored)

_clock = itertools.count(1)


@dataclass
class RadixNode:
    block: Tuple[int, ...]  # the tokens of this block (edge label)
    parent: Optional["RadixNode"]
    depth: int  # blocks from root (this node = block index depth-1)
    children: Dict[Tuple[int, ...], "RadixNode"] = field(default_factory=dict)
    tier: int = TIER_NONE
    data: object = None  # KV block payload when tier >= HOST
    on_disk: bool = False  # true once persisted by write-through
    last_access: int = 0
    lock: int = 0  # in-flight request refcount

    def touch(self) -> None:
        self.last_access = next(_clock)

    @property
    def is_leaf(self) -> bool:
        return not self.children


class RadixTree:
    def __init__(self, block_size: int):
        self.block_size = block_size
        self.root = RadixNode(block=(), parent=None, depth=0, tier=TIER_DEVICE)
        self.n_nodes = 0

    # ---------------------------------------------------------------- match
    def _blocks_of(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        B = self.block_size
        return [tuple(tokens[i * B : (i + 1) * B]) for i in range(len(tokens) // B)]

    def match_prefix(self, tokens: Sequence[int]) -> List[RadixNode]:
        """Longest path of existing nodes covering a prefix of ``tokens``.
        Returns the node chain (possibly empty); touches nodes (LRU)."""
        out: List[RadixNode] = []
        node = self.root
        for blk in self._blocks_of(tokens):
            child = node.children.get(blk)
            if child is None:
                break
            child.touch()
            out.append(child)
            node = child
        return out

    # --------------------------------------------------------------- insert
    def insert_path(self, tokens: Sequence[int]) -> List[RadixNode]:
        """Ensure nodes exist for every block of ``tokens``; returns the full
        chain.  Data/tier must be attached by the caller."""
        node = self.root
        out: List[RadixNode] = []
        for blk in self._blocks_of(tokens):
            child = node.children.get(blk)
            if child is None:
                child = RadixNode(block=blk, parent=node, depth=node.depth + 1)
                node.children[blk] = child
                self.n_nodes += 1
            child.touch()
            out.append(child)
            node = child
        return out

    # --------------------------------------------------------------evict
    def evictable_leaves(self, tier: int) -> List[RadixNode]:
        """Unlocked tier-frontier nodes, LRU-first: a node is evictable from
        ``tier`` iff none of its children still live in a tier >= ``tier``.
        This preserves the resident-path invariant (a usable KV block needs
        every ancestor block co-resident), while letting eviction cascade
        upward as children are demoted."""
        out = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if (
                n is not self.root
                and n.lock == 0
                and n.tier == tier
                and all(c.tier < tier for c in n.children.values())
            ):
                out.append(n)
        out.sort(key=lambda n: n.last_access)
        return out

    def drop(self, node: RadixNode) -> None:
        """Remove a metadata node entirely (data already off-memory)."""
        if node.children:
            raise ValueError("cannot drop an interior node")
        if node.parent is not None:
            node.parent.children.pop(node.block, None)
            self.n_nodes -= 1

    # --------------------------------------------------------------- stats
    def count_by_tier(self) -> Dict[int, int]:
        counts: Dict[int, int] = {TIER_DEVICE: 0, TIER_HOST: 0, TIER_DISK: 0, TIER_NONE: 0}
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            counts[n.tier] += 1
            stack.extend(n.children.values())
        return counts

    def lock_path(self, nodes: List[RadixNode]) -> None:
        for n in nodes:
            n.lock += 1

    def unlock_path(self, nodes: List[RadixNode]) -> None:
        for n in nodes:
            n.lock = max(0, n.lock - 1)
