"""Bytes this process has written: ``wchar`` of ``/proc/self/io`` (every
byte handed to write(2) and its kin, page cache or not).  None where the
file cannot be read."""

from __future__ import annotations

from typing import Optional


def wchar() -> Optional[int]:
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("wchar:"):
                    return int(line.split()[1])
    except OSError:
        return None
    return None
