"""LSM-tree engine: memtable + WAL + leveled/tiered sorted runs with lazy
per-level (T, K) adoption (paper §3.3, App. C).

This is the *index* of the key-value-separated design: values handed to
``put`` are small pointer records (``tensorlog.LogPointer`` + metadata), so
compaction here never rewrites tensor payloads.

Structure
---------
* level i holds up to ``K_i`` runs and ``C_i = M·∏_{j<=i} T_j`` bytes.
* flush: memtable → new run at level 0.
* compaction step (``maybe_compact``): first level violating its run-count
  or byte budget merges **all** its runs; the merged run stays at the level
  if it now fits (leveling behaviour), otherwise moves to level i+1
  (tiering cascade).  K=1 ⇒ leveling, K=T−1 ⇒ tiering, anything between is
  a valid hybrid (Dostoevsky-style).
* lazy transitions: the controller sets *target* (T, K); a level adopts the
  targets only when it next participates in a compaction — never a
  wholesale restructure (App. C.2).
"""

from __future__ import annotations

import heapq
import os
import threading
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

from .memtable import MemTable
from .sst import RunMeta, SSTReader, SSTWriter
from .wal import WAL, ManifestStore


@dataclass
class _Run:
    meta: RunMeta
    reader: SSTReader


@dataclass
class _Level:
    T: int  # size ratio adopted by this level
    K: int  # max sorted runs
    runs: List[_Run] = field(default_factory=list)  # newest first

    @property
    def bytes(self) -> int:
        return sum(r.meta.data_bytes for r in self.runs)


@dataclass
class LSMStats:
    puts: int = 0
    gets: int = 0
    get_hits: int = 0
    range_scans: int = 0
    flushes: int = 0
    compactions: int = 0
    compact_bytes_in: int = 0
    compact_bytes_out: int = 0
    bloom_negative: int = 0

    @property
    def write_amplification(self) -> float:
        return self.compact_bytes_out / max(1, self.compact_bytes_in)


class LSMTree:
    def __init__(
        self,
        root: str,
        buffer_bytes: int = 1 << 20,
        size_ratio: int = 4,
        runs_per_level: int = 1,
        block_bytes: int = 4096,
        bloom_bits_per_key: float = 10.0,
        fsync: bool = False,
    ):
        self.root = root
        os.makedirs(root, exist_ok=True)
        # One re-entrant lock serializes every structural operation
        # (memtable mutation, WAL append, flush, compaction, manifest
        # install) *and* point/range reads: reads traverse the memtable and
        # the live run list, both of which flush/compaction rewrite.  The
        # expensive I/O the serving path cares about — tensor-log payload
        # reads — lives outside this tree and stays lock-free; index
        # entries are tiny pointer records, so the critical sections here
        # are short.
        self._lock = threading.RLock()
        self.buffer_bytes = buffer_bytes
        self.block_bytes = block_bytes
        self.bloom_bits_per_key = bloom_bits_per_key
        self.fsync = fsync
        self.target_T = size_ratio
        self.target_K = runs_per_level
        self.mem = MemTable()
        self.levels: List[_Level] = []
        self.stats = LSMStats()
        self._seq = 0
        self._run_no = 0
        self.manifest = ManifestStore(root)
        self._wal_path = os.path.join(root, "wal.log")
        self._recover()
        self.wal = WAL(self._wal_path)

    # ------------------------------------------------------------------ setup
    def _recover(self) -> None:
        state = self.manifest.load()
        if state:
            self._seq = state["seq"]
            self._run_no = state["run_no"]
            self.target_T = state.get("target_T", self.target_T)
            self.target_K = state.get("target_K", self.target_K)
            for lv in state["levels"]:
                level = _Level(T=lv["T"], K=lv["K"])
                for rm in lv["runs"]:
                    path = os.path.join(self.root, rm["file"])
                    if not os.path.exists(path):
                        continue  # crashed mid-compaction before install: ignore
                    meta = RunMeta(
                        path=path,
                        min_key=bytes.fromhex(rm["min"]),
                        max_key=bytes.fromhex(rm["max"]),
                        entries=rm["entries"],
                        data_bytes=rm["bytes"],
                        seq=rm["seq"],
                    )
                    level.runs.append(_Run(meta, SSTReader(path)))
                self.levels.append(level)
        # replay WAL into memtable (records newer than last flush)
        for key, value in WAL.replay(self._wal_path):
            self.mem.put(key, value)

    def _install_manifest(self) -> None:
        state = {
            "seq": self._seq,
            "run_no": self._run_no,
            "target_T": self.target_T,
            "target_K": self.target_K,
            "levels": [
                {
                    "T": lv.T,
                    "K": lv.K,
                    "runs": [
                        {
                            "file": os.path.basename(r.meta.path),
                            "min": r.meta.min_key.hex(),
                            "max": r.meta.max_key.hex(),
                            "entries": r.meta.entries,
                            "bytes": r.meta.data_bytes,
                            "seq": r.meta.seq,
                        }
                        for r in lv.runs
                    ],
                }
                for lv in self.levels
            ],
        }
        self.manifest.install(state)

    # ------------------------------------------------------------- public API
    def put(self, key: bytes, value: Optional[bytes]) -> None:
        with self._lock:
            self.wal.append(key, value)
            self.mem.put(key, value)
            self.stats.puts += 1
            if self.fsync:
                self.wal.sync()
            if self.mem.bytes >= self.buffer_bytes:
                self.flush()

    def put_batch(self, items) -> None:
        with self._lock:
            for k, v in items:
                self.wal.append(k, v)
                self.mem.put(k, v)
                self.stats.puts += 1
            if self.fsync:
                self.wal.sync()
            if self.mem.bytes >= self.buffer_bytes:
                self.flush()

    def delete(self, key: bytes) -> None:
        self.put(key, None)

    def get(self, key: bytes):
        """(found, value). Tombstones report found=False."""
        with self._lock:
            self.stats.gets += 1
            found, v = self.mem.get(key)
            if found:
                if v is None:
                    return False, None
                self.stats.get_hits += 1
                return True, v
            for lv in self.levels:
                for run in lv.runs:  # newest first
                    if key < run.meta.min_key or key > run.meta.max_key:
                        continue
                    if key not in run.reader.bloom:
                        self.stats.bloom_negative += 1
                        continue
                    found, v = run.reader.get(key)
                    if found:
                        if v is None:
                            return False, None
                        self.stats.get_hits += 1
                        return True, v
            return False, None

    def range(self, start: bytes, end: bytes) -> Iterator:
        """Merged scan over memtable + all runs, newest shadows oldest,
        tombstones suppressed.  Materialized under the tree lock — a lazy
        generator would hold references into runs a concurrent compaction
        may close; index entries are small pointer records, so the eager
        list is cheap."""
        with self._lock:
            self.stats.range_scans += 1
            sources = [(0, self.mem.range(start, end))]  # priority 0 = newest
            pri = 1
            for lv in self.levels:
                for run in lv.runs:
                    if not (run.meta.max_key < start or run.meta.min_key >= end):
                        sources.append((pri, run.reader.range(start, end)))
                    pri += 1

            heap: List = []
            for prio, it in sources:
                try:
                    k, v = next(it)
                    heap.append((k, prio, v, it))
                except StopIteration:
                    pass
            heapq.heapify(heap)
            last_key: Optional[bytes] = None
            out: List[Tuple[bytes, bytes]] = []
            while heap:
                k, prio, v, it = heapq.heappop(heap)
                if k != last_key:
                    last_key = k
                    if v is not None:
                        out.append((k, v))
                try:
                    nk, nv = next(it)
                    heapq.heappush(heap, (nk, prio, nv, it))
                except StopIteration:
                    pass
        return iter(out)

    # ----------------------------------------------------------------- tuning
    def set_targets(self, T: int, K: int) -> None:
        """Lazy transition entry point: adopted per level at its next
        compaction (App. C)."""
        with self._lock:
            self.target_T = max(2, T)
            self.target_K = max(1, min(K, self.target_T - 1))

    def level_params(self) -> List[Tuple[int, int]]:
        with self._lock:
            return [(lv.T, lv.K) for lv in self.levels]

    # ------------------------------------------------------------ flush/merge
    def _new_run_path(self) -> str:
        self._run_no += 1
        return os.path.join(self.root, f"run_{self._run_no:08d}.sst")

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        if not len(self.mem):
            return
        w = SSTWriter(self._new_run_path(), self.block_bytes, self.bloom_bits_per_key)
        for k, v in self.mem.items():
            w.add(k, v)
        meta = w.finish()
        self._seq += 1
        meta.seq = self._seq
        if not self.levels:
            self.levels.append(_Level(T=self.target_T, K=self.target_K))
        self.levels[0].runs.insert(0, _Run(meta, SSTReader(meta.path)))
        self.mem.clear()
        self.wal.close()
        os.remove(self._wal_path)
        self.wal = WAL(self._wal_path)
        self.stats.flushes += 1
        self._install_manifest()
        self.maybe_compact()

    def _capacity(self, level_idx: int) -> int:
        cap = self.buffer_bytes
        for i in range(level_idx + 1):
            T = self.levels[i].T if i < len(self.levels) else self.target_T
            cap *= T
        return cap

    def _violation(self, i: int) -> bool:
        lv = self.levels[i]
        is_last = i == len(self.levels) - 1
        if len(lv.runs) > lv.K:
            return True
        if not is_last and lv.bytes > self._capacity(i):
            return True
        # last level: merge only on run-count overflow (it may grow in bytes)
        return False

    def maybe_compact(self, max_steps: int = 64) -> int:
        """Run up to ``max_steps`` single-level compactions; returns count."""
        with self._lock:
            steps = 0
            while steps < max_steps:
                victim = None
                for i in range(len(self.levels)):
                    if self._violation(i):
                        victim = i
                        break
                if victim is None:
                    return steps
                self._compact_level(victim)
                steps += 1
            return steps

    def _merge_runs(self, runs: List[_Run], drop_tombstones: bool) -> Optional[RunMeta]:
        w = SSTWriter(self._new_run_path(), self.block_bytes, self.bloom_bits_per_key)
        heap: List = []
        for prio, run in enumerate(runs):  # newest first
            it = run.reader.items()
            try:
                k, v = next(it)
                heap.append((k, prio, v, it))
            except StopIteration:
                pass
        heapq.heapify(heap)
        last_key = None
        wrote = 0
        while heap:
            k, prio, v, it = heapq.heappop(heap)
            if k != last_key:
                last_key = k
                if v is not None or not drop_tombstones:
                    w.add(k, v)
                    wrote += 1
            try:
                nk, nv = next(it)
                heapq.heappush(heap, (nk, prio, nv, it))
            except StopIteration:
                pass
        meta = w.finish()
        if wrote == 0:
            os.remove(meta.path)
            return None
        return meta

    def _compact_level(self, i: int) -> None:
        lv = self.levels[i]
        runs = lv.runs
        bytes_in = sum(r.meta.data_bytes for r in runs)
        is_last = i == len(self.levels) - 1
        merged = self._merge_runs(runs, drop_tombstones=is_last)
        # lazy adoption of target parameters at this level (App. C)
        lv.T, lv.K = self.target_T, self.target_K
        for r in runs:
            r.reader.close()
        old_paths = [r.meta.path for r in runs]
        lv.runs = []
        if merged is not None:
            self._seq += 1
            merged.seq = self._seq
            dest = i
            if not is_last and merged.data_bytes > self._capacity(i):
                dest = i + 1
            elif is_last and merged.data_bytes > self._capacity(i):
                dest = i + 1  # grow the tree by one level
            if dest >= len(self.levels):
                self.levels.append(_Level(T=self.target_T, K=self.target_K))
            self.levels[dest].runs.insert(0, _Run(merged, SSTReader(merged.path)))
            self.stats.compact_bytes_out += merged.data_bytes
        self.stats.compactions += 1
        self.stats.compact_bytes_in += bytes_in
        self._install_manifest()
        for p in old_paths:
            try:
                os.remove(p)
            except OSError:
                pass

    def compact_all(self) -> None:
        while self.maybe_compact(max_steps=1):
            pass

    # ------------------------------------------------------------------ misc
    @property
    def n_entries(self) -> int:
        with self._lock:
            return len(self.mem) + sum(r.meta.entries for lv in self.levels for r in lv.runs)

    @property
    def disk_bytes(self) -> int:
        with self._lock:
            return sum(r.meta.data_bytes for lv in self.levels for r in lv.runs)

    @property
    def n_runs(self) -> int:
        with self._lock:
            return sum(len(lv.runs) for lv in self.levels)

    def close(self) -> None:
        with self._lock:
            self.wal.sync()
            self.wal.close()
            for lv in self.levels:
                for r in lv.runs:
                    r.reader.close()
