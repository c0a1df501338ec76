"""Consistent-hash ring for cache-node placement.

Each node owns ``vnodes`` pseudo-random points on a 64-bit ring; a key
hashes to a point and its *preference list* is the distinct nodes met
walking clockwise from there.  Replica sets are prefixes of the
preference list, which gives the two properties the cluster layer needs:

* **Minimal movement** — adding or removing one node only remaps the
  ring arcs that node's points owned (~1/N of the keyspace), so a node
  rejoin is a local rebalance, not a full reshuffle (contrast modulo
  hashing, where N → N±1 remaps almost every key).
* **Stable failover order** — the preference list with node *k* filtered
  out is exactly the preference list of the ring without *k*: readers
  that skip a dead node land on the same replica that writes re-routed
  to, with no coordination.

Keys are the same first-block routing hash ``ShardedKVBlockStore`` uses
(``key_hash``), so a whole prefix tree lands on one node and probes stay
node-local — the cross-process analogue of in-process sharding.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import List, Sequence, Tuple

from ..core.keycodec import TOKEN_WIDTH, encode_tokens


def key_hash(tokens: Sequence[int], block_size: int) -> int:
    """64-bit ring position of a token sequence: hash of the first block
    (stable across processes — blake2b, never ``hash()``)."""
    head = encode_tokens(tokens[: min(block_size, len(tokens))])
    return int.from_bytes(hashlib.blake2b(head, digest_size=8).digest(), "little")


def raw_key_hash(key: bytes, block_size: int) -> int:
    """Ring position of an already-encoded index key.  The key is the
    big-endian token encoding, so its first ``TOKEN_WIDTH * block_size``
    bytes are exactly ``encode_tokens(tokens[:block_size])`` — a node can
    place any stored key on the ring without decoding tokens."""
    head = bytes(key[: TOKEN_WIDTH * block_size])
    return int.from_bytes(hashlib.blake2b(head, digest_size=8).digest(), "little")


def _point(node_id: str, vnode: int) -> int:
    h = hashlib.blake2b(f"{node_id}#{vnode}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little")


class HashRing:
    """Immutable ring over ``node_ids`` (index-addressed).  One ring never
    rehashes — runtime *failures* are handled by the caller filtering its
    down-set out of preference lists.  Membership *changes* are a new
    ring: the cluster store holds the old and new rings side by side as a
    ``TransitionView`` while ``cluster.migration`` copies the moved arcs,
    then drops the old ring."""

    def __init__(self, node_ids: Sequence[str], vnodes: int = 64):
        if not node_ids:
            raise ValueError("ring needs at least one node")
        if len(set(node_ids)) != len(node_ids):
            raise ValueError(f"duplicate node ids: {list(node_ids)}")
        self.node_ids = list(node_ids)
        self.vnodes = vnodes
        pts = [
            (_point(nid, v), idx)
            for idx, nid in enumerate(self.node_ids)
            for v in range(vnodes)
        ]
        pts.sort()
        self._points = [p for p, _ in pts]
        self._owners = [i for _, i in pts]

    def __len__(self) -> int:
        return len(self.node_ids)

    def preference(self, khash: int) -> List[int]:
        """All node indices in clockwise order from ``khash`` (each node
        once, first occurrence wins).  ``preference(k)[:r]`` is the
        r-replica set; survivors keep their relative order when a node is
        filtered out."""
        start = bisect.bisect_left(self._points, khash) % len(self._points)
        seen: List[int] = []
        mask = set()
        for i in range(len(self._points)):
            owner = self._owners[(start + i) % len(self._points)]
            if owner not in mask:
                mask.add(owner)
                seen.append(owner)
                if len(seen) == len(self.node_ids):
                    break
        return seen

    def primary(self, khash: int) -> int:
        return self.preference(khash)[0]

    def preference_ids(self, khash: int) -> List[str]:
        """``preference`` mapped to node ids — the stable vocabulary for
        comparing placement across two rings (indices are ring-local)."""
        return [self.node_ids[i] for i in self.preference(khash)]


_RING_BITS = 64
_RING_SIZE = 1 << _RING_BITS


def in_arc(lo: int, hi: int, khash: int) -> bool:
    """True iff ``khash`` lies in the half-open wrapping arc ``(lo, hi]``.

    Arcs are half-open on the *low* side because ``preference`` uses
    ``bisect_left``: a key hashing exactly onto a ring point is owned by
    that point, so the arc owned by point ``p`` with predecessor ``q`` is
    ``(q, p]``.  ``lo == hi`` denotes the full ring.
    """
    if lo == hi:
        return True
    if lo < hi:
        return lo < khash <= hi
    return khash > lo or khash <= hi


def _merge_arcs(arcs: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Coalesce adjacent elementary arcs (``a.hi == b.lo``), including the
    pair that meets across the 0 wrap."""
    if not arcs:
        return []
    merged: List[Tuple[int, int]] = [arcs[0]]
    for lo, hi in arcs[1:]:
        if merged[-1][1] == lo:
            merged[-1] = (merged[-1][0], hi)
        else:
            merged.append((lo, hi))
    if len(merged) > 1 and merged[-1][1] == merged[0][0]:
        merged[0] = (merged[-1][0], merged[0][1])
        merged.pop()
    return merged


def moved_arcs(old: "HashRing", new: "HashRing", replicas: int) -> List[Tuple[int, int]]:
    """Arcs of the keyspace whose r-replica owner set *gained a node* going
    from ``old`` to ``new``.

    Walks the elementary arcs induced by the union of both rings' points
    (within one such arc, both preference lists are constant) and keeps
    the arcs where some new owner is not an old owner — exactly the keys
    a migration has to copy.  Keys whose owner set only *shrank* need no
    copying: the surviving owners already hold them.  Returned arcs are
    half-open ``(lo, hi]`` (see ``in_arc``), merged where adjacent;
    ``[(h, h)]`` — the full ring — may be returned for single-point
    degenerate cases.
    """
    r = max(1, replicas)
    bounds = sorted(set(old._points) | set(new._points))
    if not bounds:
        return []
    moved: List[Tuple[int, int]] = []
    for i, hi in enumerate(bounds):
        lo = bounds[i - 1] if i else bounds[-1]
        # representative: the arc's inclusive upper bound
        old_ids = set(old.preference_ids(hi)[:r])
        new_ids = set(new.preference_ids(hi)[:r])
        if not new_ids <= old_ids:
            moved.append((lo, hi))
    if len(moved) == len(bounds):
        h = bounds[0]
        return [(h, h)]  # whole ring moved
    return _merge_arcs(moved)


class TransitionView:
    """Two-ring routing during a membership change.

    Writes target the **new** ring only (new data should land where it
    will live).  Reads consult the new owners first, then the old owners,
    so a key is reachable *wherever it currently lives* while
    ``cluster.migration`` copies the ``moved`` arcs in the background.
    Once the migrator drains, the cluster store drops the view and the
    new ring stands alone.
    """

    def __init__(self, old: HashRing, new: HashRing, replicas: int):
        self.old = old
        self.new = new
        self.replicas = max(1, replicas)
        self.moved = moved_arcs(old, new, self.replicas)

    def key_moved(self, khash: int) -> bool:
        return any(in_arc(lo, hi, khash) for lo, hi in self.moved)

    def write_ids(self, khash: int) -> List[str]:
        return self.new.preference_ids(khash)

    def read_ids(self, khash: int) -> List[str]:
        """New-ring r-owners, then old-ring r-owners, deduplicated in
        order.  Every pre-transition replica location appears, so no key
        is lost between old and new ownership mid-migration."""
        r = self.replicas
        out = list(self.new.preference_ids(khash)[:r])
        seen = set(out)
        for nid in self.old.preference_ids(khash)[:r]:
            if nid not in seen:
                seen.add(nid)
                out.append(nid)
        return out


def affected_arcs(ring: HashRing, node_ids: Sequence[str], replicas: int) -> List[Tuple[int, int]]:
    """Arcs whose r-replica owner set intersects ``node_ids`` — the key
    ranges that lost a replica when those nodes died, i.e. the ranges a
    replica repair has to re-copy onto the surviving owners."""
    r = max(1, replicas)
    targets = set(node_ids)
    bounds = ring._points
    if not bounds:
        return []
    hit: List[Tuple[int, int]] = []
    for i, hi in enumerate(bounds):
        lo = bounds[i - 1] if i else bounds[-1]
        if targets & set(ring.preference_ids(hi)[:r]):
            hit.append((lo, hi))
    if len(hit) == len(bounds):
        h = bounds[0]
        return [(h, h)]
    return _merge_arcs(hit)
