#!/usr/bin/env python3
"""Time one LSM-store get of a glm4-9b document's blocks, in two or more
checkouts, alone and beside a thread that runs pure Python.

    python3 scripts/store_get_ab.py --trees OLD NEW [--pairs 5] [--blocks 113]

Each tree is a directory holding a checkout's ``src/`` (for the parent
commit: ``git archive HEAD | tar -x -C DIR``).  Each run is a process of
its own, in turns A B, B A, ... (the order reversed every round), so a
drift of the host lands on every side.  The process builds a
``KVBlockStore`` as the serve path deploys one (block 16, int8 + zlib 1)
under a temporary directory, puts ``--blocks`` seeded glm4-9b blocks
(16 x 20480 float16, 40 layers x k, v x 2 KV heads x 128), flushes, and
times ``get_batch`` of all of them, ``--reps`` times each: alone; beside
one thread building and sorting dicts in a loop (the engine thread's
radix-tree walks stand in); and as two gets at once.  It prints one JSON
line: the medians in ms, the share of blocks the store's native decoder
decoded (``native_decode_blocks`` / ``get_blocks``; absent where the
store has no such counter) and a hash of the arrays got, which must be
equal in every tree.  Needs no GPU: it measures the host.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

CHILD = r"""
import hashlib, json, statistics, sys, tempfile, threading, time
sys.path.insert(0, "src")
import numpy as np
from repro_torch.core.codec import CODEC_INT8, BatchCodec
from repro_torch.core.store import KVBlockStore

n_blocks, reps = int(sys.argv[1]), int(sys.argv[2])
rng = np.random.default_rng(37)
blocks = [rng.standard_normal((16, 20480)).astype(np.float16) for _ in range(n_blocks)]
toks = [(7 * i) % 50021 + 1 for i in range(16 * n_blocks)]


def busy(stop):
    while not stop.is_set():
        d = {i: (i * 7919) % 1009 for i in range(20000)}
        sorted(d.items(), key=lambda kv: kv[1])


def timed(fn):
    t = time.perf_counter()
    fn()
    return (time.perf_counter() - t) * 1e3


with tempfile.TemporaryDirectory() as root:
    st = KVBlockStore(root, block_size=16, codec=BatchCodec(CODEC_INT8, use_zlib=True, zlib_level=1))
    st.put_batch(toks, blocks)
    st.flush()
    got = st.get_batch(toks, len(toks))
    digest = hashlib.sha1(b"".join(a.tobytes() for a in got)).hexdigest()[:16]
    get = lambda: st.get_batch(toks, len(toks))
    alone = [timed(get) for _ in range(reps)]
    stop = threading.Event()
    th = threading.Thread(target=busy, args=(stop,))
    th.start()
    try:
        time.sleep(0.05)
        beside = [timed(get) for _ in range(reps)]
    finally:
        stop.set()
        th.join()

    def two():
        other = threading.Thread(target=get)
        other.start()
        get()
        other.join()

    both = [timed(two) for _ in range(reps)]
    s = st.stats
    native = getattr(s, "native_decode_blocks", None)
    print(json.dumps({"alone_ms": statistics.median(alone), "beside_python_ms": statistics.median(beside),
                      "two_gets_ms": statistics.median(both), "get_blocks": s.get_blocks,
                      "native_share": None if native is None else native / s.get_blocks, "digest": digest}))
    st.close()
"""

KEYS = ("alone_ms", "beside_python_ms", "two_gets_ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--blocks", type=int, default=113)
    ap.add_argument("--reps", type=int, default=9)
    args = ap.parse_args()
    runs = {t: [] for t in args.trees}
    for r in range(args.pairs):
        order = args.trees if r % 2 == 0 else args.trees[::-1]
        for tree in order:
            out = subprocess.run([sys.executable, "-c", CHILD, str(args.blocks), str(args.reps)], cwd=tree,
                                 capture_output=True, text=True, env=dict(os.environ, PYTHONPATH="src"))
            if out.returncode != 0:
                sys.stderr.write(out.stderr[-3000:])
                return 1
            line = json.loads(out.stdout.strip().splitlines()[-1])
            runs[tree].append(line)
            print(json.dumps({"tree": tree, "round": r, **line}), flush=True)
    digests = {line["digest"] for lines in runs.values() for line in lines}
    print(f"arrays equal in every run: {len(digests) == 1}")
    for tree, lines in runs.items():
        med = {k: round(statistics.median(line[k] for line in lines), 2) for k in KEYS}
        print(json.dumps({"tree": tree, "cpus": len(os.sched_getaffinity(0)), "median_ms": med,
                          "ranges_ms": {k: [round(min(x[k] for x in lines), 2), round(max(x[k] for x in lines), 2)]
                                        for k in KEYS},
                          "native_share": lines[-1]["native_share"]}))
    return 0 if len(digests) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
