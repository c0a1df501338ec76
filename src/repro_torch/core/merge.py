"""Automatic tensor-file merging + GC (paper §3.4 'Automatic Tensor File
Merging').

Activates when the tensor-log file count exceeds a threshold or a file's
garbage ratio passes a bound; live records from victim files are re-appended
to the active log (consolidating many small/stale files into few large
ones), and the corresponding ``file_id + offset`` index entries are
rewritten in the LSM-tree.  Scheduled from the store's maintenance cycle so
it rides along natural compaction windows rather than competing with
request processing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from .tensorlog import LogPointer, TensorLog


@dataclass
class MergeReport:
    files_removed: int = 0
    records_moved: int = 0
    bytes_reclaimed: int = 0


class TensorFileMerger:
    def __init__(
        self,
        log: TensorLog,
        index,  # LSMTree holding key -> packed pointer (+meta) entries
        max_files: int = 64,
        garbage_threshold: float = 0.5,
        value_codec=None,  # (unpack, pack) hooks from the store: value <-> ptr
    ):
        self.log = log
        self.index = index
        self.max_files = max_files
        self.garbage_threshold = garbage_threshold
        if value_codec is None:
            value_codec = (
                lambda v: LogPointer.unpack(v),
                lambda ptr, old_v: ptr.pack() + old_v[20:],
            )
        self._unpack, self._pack = value_codec

    def _victims(self) -> List[int]:
        ids = self.log.file_ids()
        if not ids:
            return []
        active = ids[-1]
        victims = [f for f in ids if f != active and self.log.garbage_ratio(f) >= self.garbage_threshold]
        # file-count pressure: merge oldest files first until under threshold
        if self.log.file_count > self.max_files:
            extra = [f for f in ids if f != active and f not in victims]
            need = self.log.file_count - self.max_files
            victims.extend(extra[:need])
        return sorted(set(victims))

    def needed(self) -> bool:
        return bool(self._victims())

    def run(self, max_victims: int = 8) -> MergeReport:
        rep = MergeReport()
        for fid in self._victims()[:max_victims]:
            moved: List = []  # (key, old_value, payload)
            for ptr, key, payload in self.log.scan_file(fid):
                found, v = self.index.get(key)
                if not found:
                    continue  # evicted/stale: garbage
                cur = self._unpack(v)
                if (cur.file_id, cur.offset) != (ptr.file_id, ptr.offset):
                    continue  # superseded copy: garbage
                moved.append((key, v, payload))
            if moved:
                new_ptrs = self.log.append_batch([(k, p) for k, _, p in moved])
                self.index.put_batch(
                    (k, self._pack(np_, old_v)) for (k, old_v, _), np_ in zip(moved, new_ptrs)
                )
                rep.records_moved += len(moved)
            size = self.log._files.get(fid, {}).get("size", 0)
            self.log.remove_file(fid)
            rep.files_removed += 1
            rep.bytes_reclaimed += size
        return rep
