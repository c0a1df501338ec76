"""Adaptive compression tiers (ROADMAP item 1; paper §3.4): codec choice
as a per-block storage *policy* rather than a store-wide constant.

Blocks are written raw (**hot** — the put path pays zero codec CPU), then
demoted by the off-path maintenance cycle as they cool: **warm** blocks are
re-encoded int8 (per-channel symmetric quantization, ~4x), **cold** blocks
int8+zlib.  Recency comes from bookkeeping the tensor log already keeps —
each log file's last-access time — so the policy costs the hot path
nothing.  Demotion rides the same mechanics as tensor-file merging: scan a
sealed victim file, transcode live records, re-append them to the active
log, repoint the index, remove the victim.  Lock-free readers that lose
the race see ``FileNotFoundError`` and re-resolve from the index, exactly
as for merge/eviction (see ``core.tensorlog``).

The tier tag lives in the index entry's flags byte (``LogPointer(20B) |
u8 flags``, bits 0–1), so per-tier accounting never touches payloads; the
payloads themselves stay self-describing (``core.codec`` header), so
decode anywhere — store, hierarchy fulfill, cluster client — needs no
side channel.

State machine::

    put ──► HOT (raw) ──idle ≥ warm_after_s──► WARM (int8)
                 │                                  │
                 └──────idle ≥ cold_after_s─────────┴──► COLD (int8+zlib)

Demotion only moves down-tier; a re-read does not promote (re-inflating a
block would cost a rewrite for no capacity gain) but it *does* refresh the
file's access time, so files holding traffic stop demoting further.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from .codec import CODEC_INT8, CODEC_RAW, BatchCodec, transcode

TIER_HOT = 0
TIER_WARM = 1
TIER_COLD = 2
TIER_MASK = 0x03  # bits 0-1 of the index-entry flags byte
TIER_NAMES = ("hot", "warm", "cold")

_TIER_CODECS = (
    BatchCodec(CODEC_RAW, use_zlib=False),
    BatchCodec(CODEC_INT8, use_zlib=False),
    BatchCodec(CODEC_INT8, use_zlib=True),
)


def tier_of_codec(codec: BatchCodec) -> int:
    """The tier a static store-wide codec corresponds to, so per-tier
    gauges stay meaningful on stores running without an adaptive policy
    (raw → hot, int8 → warm, int8+zlib → cold)."""
    if codec.codec == CODEC_INT8:
        return TIER_COLD if codec.use_zlib else TIER_WARM
    return TIER_HOT


@dataclass
class TieringPolicy:
    """When to demote: a sealed log file idle for ``warm_after_s`` becomes
    a warm victim, for ``cold_after_s`` a cold victim.  Zero thresholds
    demote at the next maintenance cycle (benchmarks and tests use this
    for deterministic demotion).  ``max_files_per_cycle`` bounds per-cycle
    re-encode work the same way merge bounds its victims."""

    warm_after_s: float = 30.0
    cold_after_s: float = 120.0
    max_files_per_cycle: int = 4
    zlib_level: int = 1

    def __post_init__(self) -> None:
        if self.cold_after_s < self.warm_after_s:
            raise ValueError(
                f"cold_after_s ({self.cold_after_s}) must be >= "
                f"warm_after_s ({self.warm_after_s})"
            )

    def codec_for(self, tier: int) -> BatchCodec:
        c = _TIER_CODECS[tier]
        if tier == TIER_COLD and self.zlib_level != 1:
            return BatchCodec(CODEC_INT8, use_zlib=True, zlib_level=self.zlib_level)
        return c

    def target_tier(self, idle_s: float) -> int:
        if idle_s >= self.cold_after_s:
            return TIER_COLD
        if idle_s >= self.warm_after_s:
            return TIER_WARM
        return TIER_HOT


@dataclass
class TierReport:
    """One recoder cycle, JSON-shaped for the maintenance report."""

    files: int = 0
    demoted_blocks: int = 0
    moved_blocks: int = 0  # live records rewritten (demoted or carried)
    bytes_before: int = 0  # pre-transcode payload bytes of demoted blocks
    bytes_after: int = 0
    transitions: Dict[str, int] = None  # "hot->warm" etc. -> block count

    def __post_init__(self) -> None:
        if self.transitions is None:
            self.transitions = {}

    def as_dict(self) -> dict:
        return {
            "files": self.files,
            "demoted_blocks": self.demoted_blocks,
            "moved_blocks": self.moved_blocks,
            "bytes_before": self.bytes_before,
            "bytes_after": self.bytes_after,
            "transitions": dict(self.transitions),
        }


class TierRecoder:
    """Off-path tier demotion over the tensor log, mirroring
    ``TensorFileMerger``: runs inside the store's maintenance cycle under
    the store mutation lock, never on the put/get path.

    ``entry_codec`` is ``(unpack(v) -> (ptr, flags), pack(ptr, flags) ->
    bytes)`` from the store — the recoder owns no entry-layout knowledge.
    """

    def __init__(
        self,
        log,  # TensorLog
        index,  # LSMTree: key -> packed (ptr | flags) entries
        policy: TieringPolicy,
        entry_codec: Tuple[Callable, Callable],
    ):
        self.log = log
        self.index = index
        self.policy = policy
        self._unpack, self._pack = entry_codec
        # Files whose surviving records are all at (or below) this tier
        # already — skip rescanning them until a colder target applies.
        # File ids are never reused, so stale entries are harmless.
        self._settled: Dict[int, int] = {}

    def _victims(self, now: float) -> List[Tuple[int, int]]:
        """Sealed files due for demotion, oldest-idle first: (fid, target)."""
        ids = self.log.file_ids()
        if len(ids) < 2:
            return []  # only the active file (or empty): nothing sealed
        active = ids[-1]
        out = []
        for fid in ids:
            if fid == active:
                continue
            idle = self.log.idle_s(fid, now)
            target = self.policy.target_tier(idle)
            if target == TIER_HOT or self._settled.get(fid, -1) >= target:
                continue
            out.append((idle, fid, target))
        out.sort(reverse=True)  # most-idle first: coldest data demotes first
        return [(fid, target) for _, fid, target in out[: self.policy.max_files_per_cycle]]

    def needed(self, now: Optional[float] = None) -> bool:
        return bool(self._victims(time.monotonic() if now is None else now))

    def run(self, now: Optional[float] = None) -> TierReport:
        now = time.monotonic() if now is None else now
        rep = TierReport()
        for fid, target in self._victims(now):
            codec = self.policy.codec_for(target)
            moved = []  # (key, payload_bytes, flags)
            demoted = 0
            for ptr, key, payload in self.log.scan_file(fid):
                found, v = self.index.get(key)
                if not found:
                    continue  # evicted/stale: garbage, dropped by the rewrite
                cur_ptr, flags = self._unpack(v)
                if (cur_ptr.file_id, cur_ptr.offset) != (ptr.file_id, ptr.offset):
                    continue  # superseded copy: garbage
                tier = flags & TIER_MASK
                if tier >= target:
                    # already at/below target (e.g. merge carried a cold
                    # record into a young file): carry unchanged
                    moved.append((key, bytes(payload), flags))
                    continue
                new_payload = transcode(payload, codec)
                if new_payload is None:  # payload already target-encoded
                    moved.append((key, bytes(payload), (flags & ~TIER_MASK) | target))
                    continue
                rep.bytes_before += len(payload)
                rep.bytes_after += len(new_payload)
                demoted += 1
                key_t = TIER_NAMES[tier] + "->" + TIER_NAMES[target]
                rep.transitions[key_t] = rep.transitions.get(key_t, 0) + 1
                moved.append((key, new_payload, (flags & ~TIER_MASK) | target))
            if demoted == 0:
                # nothing to transcode: leave the file in place (merge still
                # handles its garbage) and remember it is settled at target
                self._settled[fid] = target
                continue
            if moved:
                # same publish ordering as merge: append, repoint the index,
                # *then* remove the victim — racing lock-free readers retry
                # off the repointed index
                new_ptrs = self.log.append_batch([(k, p) for k, p, _ in moved])
                self.index.put_batch(
                    (k, self._pack(np_, fl)) for (k, _, fl), np_ in zip(moved, new_ptrs)
                )
            self.log.remove_file(fid)
            self._settled.pop(fid, None)
            rep.files += 1
            rep.demoted_blocks += demoted
            rep.moved_blocks += len(moved)
        return rep
