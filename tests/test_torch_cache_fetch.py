"""The port's cache fetch reads from disk only the blocks the device tier
did not hold at plan time, and the ranged ``get_batch`` beneath it.

Each hierarchy scenario runs the same plan / fetch / fulfill / commit calls
through the port's ``CacheHierarchy`` and the reference's (the reference's
cache and store are jax-free), each over its own ``ShardedKVBlockStore``:
every ``Acquisition``, the ``CacheStats`` hit counts and every node of the
two radix trees (tier, disk flag, block array) stay equal, while the port
reads fewer blocks.  The ranged get of every backend equals the full get's
tail."""

import hashlib
from dataclasses import dataclass, fields
from typing import List, Optional

import numpy as np
import pytest

from repro.cache import hierarchy as ref_hierarchy
from repro.core import sharded_store as ref_sharded
from repro_torch.cache import hierarchy
from repro_torch.cache.radix import TIER_DEVICE, TIER_DISK, TIER_HOST
from repro_torch.core.baselines import FilePerObjectStore, MemoryOnlyStore
from repro_torch.core.codec import CODEC_RAW, BatchCodec
from repro_torch.core.sharded_store import ShardedKVBlockStore
from repro_torch.core.store import KVBlockStore
from repro_torch.obs.tracing import TraceContext, activate

B = 4  # tokens a block
SHAPE = (2, B, 6)  # one block's KV: k and v, B tokens, 6 channels


def seq(doc: int, n_blocks: int, tail: int = 0, tail_blocks: int = 0) -> List[int]:
    """Document ``doc``'s first ``n_blocks`` blocks, then ``tail_blocks``
    blocks of question ``tail``."""
    toks = [(37 * doc + 11 * i) % 997 + 1 for i in range(n_blocks * B)]
    return toks + [(53 * tail + 7 * i) % 991 + 1000 for i in range(tail_blocks * B)]


def block(tokens: List[int], i: int) -> np.ndarray:
    """Block ``i``'s KV, drawn from its whole token prefix."""
    digest = hashlib.sha256(np.asarray(tokens[: (i + 1) * B], np.int64).tobytes()).digest()
    rng = np.random.default_rng(int.from_bytes(digest[:8], "little"))
    return rng.standard_normal(SHAPE).astype(np.float16)


class Streaming:
    """A streaming backend over a local store: ``get_batch_stream`` and a
    ``get_batch`` with no start, as the cluster's clients have; records the
    block counts asked of each."""

    def __init__(self, store):
        self.store = store
        self.streamed: List[int] = []
        self.got: List[int] = []

    def __getattr__(self, name):
        return getattr(self.store, name)

    def get_batch_stream(self, tokens, n_tokens):
        self.streamed.append(n_tokens // B)
        return iter(self.store.get_batch(tokens, n_tokens))

    def get_batch(self, tokens, n_tokens):
        self.got.append(n_tokens // B)
        return self.store.get_batch(tokens, n_tokens)


@dataclass
class Side:
    h: object
    store: object

    @property
    def read(self) -> int:
        store = getattr(self.store, "store", self.store)
        return store.stats.get_blocks


class Pair:
    """The port's hierarchy and the reference's, each over its own store,
    driven by the same calls."""

    def __init__(self, tmp_path, device: int, host: int, streaming: bool = False):
        self.sides = []
        for name, mod, store_mod in (("port", hierarchy, None), ("ref", ref_hierarchy, ref_sharded)):
            cls = ShardedKVBlockStore if store_mod is None else store_mod.ShardedKVBlockStore
            store = cls(str(tmp_path / name), n_shards=2, block_size=B)
            backend = Streaming(store) if streaming else store
            self.sides.append(Side(mod.CacheHierarchy(B, device, host, store=backend), backend))
        self.port, self.ref = self.sides

    def close(self):
        for s in self.sides:
            getattr(s.store, "store", s.store).close()

    def put(self, tokens):
        """Write a sequence's blocks straight into both stores (a store
        another engine filled)."""
        for s in self.sides:
            s.store.put_batch(tokens, [block(tokens, i) for i in range(len(tokens) // B)])

    def plan(self, tokens):
        return [s.h.plan(tokens) for s in self.sides]

    def fetch(self, plans):
        return [s.h.fetch(p) for s, p in zip(self.sides, plans)]

    def fulfill(self, plans, fetched):
        acqs = [s.h.fulfill(p, f) for s, p, f in zip(self.sides, plans, fetched)]
        assert_same_acquisition(*acqs)
        return acqs

    def commit(self, tokens, acqs):
        for s, acq in zip(self.sides, acqs):
            fresh = [block(tokens, i) for i in range(acq.reuse_tokens // B, len(tokens) // B)]
            s.h.commit(tokens, fresh, acq)
            s.h.release(acq)

    def serve(self, tokens):
        """A whole request: plan, fetch, fulfill, commit the fresh blocks."""
        plans = self.plan(tokens)
        acqs = self.fulfill(plans, self.fetch(plans))
        self.commit(tokens, acqs)
        return acqs


def assert_same_acquisition(port, ref):
    for f in ("reuse_tokens", "device_tokens", "host_tokens", "disk_tokens"):
        assert getattr(port, f) == getattr(ref, f), f
    assert [n.depth for n in port.nodes] == [n.depth for n in ref.nodes]
    for a, b in zip(port.nodes, ref.nodes):
        assert a.tier == b.tier and np.array_equal(a.data, b.data)


def tree(h) -> dict:
    """Every node of the radix tree: path -> (tier, on_disk, data)."""
    out, stack = {}, [((), h.tree.root)]
    while stack:
        path, node = stack.pop()
        for blk, child in node.children.items():
            out[path + blk] = (child.tier, child.on_disk, child.data)
            stack.append((path + blk, child))
    return out


def assert_same_state(pair: Pair):
    port, ref = tree(pair.port.h), tree(pair.ref.h)
    assert port.keys() == ref.keys()
    for k in port:
        (pt, pd, pa), (rt, rd, ra) = port[k], ref[k]
        assert (pt, pd) == (rt, rd), k
        assert (pa is None) == (ra is None) and (pa is None or np.array_equal(pa, ra)), k
    new = {"fetch_skipped_blocks", "late_read_blocks"}
    reads = {"promote_s", "first_block_s", "streamed_fetches"}  # times, and fetches that read
    for f in fields(ref_hierarchy.CacheStats):
        if f.name not in reads:
            assert getattr(pair.port.h.stats, f.name) == getattr(pair.ref.h.stats, f.name), f.name
    assert pair.port.h.stats.streamed_fetches <= pair.ref.h.stats.streamed_fetches
    assert {f.name for f in fields(hierarchy.CacheStats)} == {f.name for f in fields(ref_hierarchy.CacheStats)} | new
    assert (pair.port.h.device_blocks, pair.port.h.host_blocks) == (pair.ref.h.device_blocks, pair.ref.h.host_blocks)


def chain_tiers(h, tokens) -> List[int]:
    return [n.tier for n in h.tree.match_prefix(tokens)]


DOC = 6  # a document's blocks
Q = 2  # a question's blocks


def scenario_device_chain(pair: Pair) -> int:
    """(a) The document on the device, fresh question blocks: no get."""
    pair.serve(seq(0, DOC, 0, Q))
    tokens = seq(0, DOC, 1, Q)
    assert chain_tiers(pair.port.h, tokens) == [TIER_DEVICE] * DOC
    before = [s.read for s in pair.sides]
    pair.serve(tokens)
    port, ref = (s.read - b for s, b in zip(pair.sides, before))
    assert (port, ref) == (0, DOC)
    return DOC


def scenario_host_tail(pair: Pair) -> int:
    """(b) A device prefix and a host tail: only the tail is read."""
    pair.serve(seq(0, DOC))
    pair.serve(seq(1, 4))  # demotes the document's last two blocks to host
    tokens = seq(0, DOC, 1, Q)
    assert chain_tiers(pair.port.h, tokens) == [TIER_DEVICE] * 4 + [TIER_HOST] * 2
    before = [s.read for s in pair.sides]
    pair.serve(tokens)
    port, ref = (s.read - b for s, b in zip(pair.sides, before))
    assert (port, ref) == (2, DOC)
    return 4


def scenario_disk_tail_and_extension(pair: Pair) -> int:
    """(c) A device prefix, a disk tail, and blocks on disk past the
    chain: read from the device run on."""
    pair.put(seq(0, 10))  # another engine stored the whole document
    pair.serve(seq(0, DOC))
    pair.serve(seq(1, 4))  # the document's tail leaves the device
    pair.serve(seq(2, 4))  # and the host
    tokens = seq(0, 10, 1, Q)
    tiers = chain_tiers(pair.port.h, tokens)
    assert len(tiers) == DOC and TIER_DISK in tiers
    run = tiers.index(next(t for t in tiers if t != TIER_DEVICE))
    assert run > 0
    before = [s.read for s in pair.sides]
    acq, _ = pair.serve(tokens)
    assert acq.reuse_tokens == 10 * B
    port, ref = (s.read - b for s, b in zip(pair.sides, before))
    assert (port, ref) == (10 - run, 10)
    return run


def scenario_hole_below_device_run(pair: Pair) -> int:
    """(c') As (c), but the disk lost a block below the device run: the
    reference's get from block 0 stops at the hole, so the disk tail is a
    miss on both sides; the port reads none of it."""
    pair.serve(seq(0, DOC))
    pair.serve(seq(1, 4))
    pair.serve(seq(2, 4))
    tokens = seq(0, DOC, 1, Q)
    tiers = chain_tiers(pair.port.h, tokens)
    assert TIER_DISK in tiers
    run = tiers.index(next(t for t in tiers if t != TIER_DEVICE))
    assert run >= 2
    for s in pair.sides:  # an evicted log file took block run - 1 away
        shard = s.store.shard_for(tokens)
        shard.index.delete(shard._key(tokens, run * B))
        shard._may_have_holes = True
    before = [s.read for s in pair.sides]
    acq, _ = pair.serve(tokens)
    assert acq.disk_tokens == 0
    port, ref = (s.read - b for s, b in zip(pair.sides, before))
    assert (port, ref) == (0, run - 1)
    return run


def scenario_spilled_after_plan(pair: Pair) -> int:
    """(d) The plan sees the document on the device; two requests spill its
    tail to disk before fulfill, which reads those blocks late."""
    pair.serve(seq(0, DOC))
    tokens = seq(0, DOC, 1, Q)
    plans = pair.plan(tokens)
    fetched = pair.fetch(plans)
    assert fetched[0].start_block == DOC and not fetched[0].blocks
    pair.serve(seq(1, 4))
    pair.serve(seq(2, 4))
    spilled = chain_tiers(pair.port.h, tokens).count(TIER_DISK)
    assert spilled > 0
    before = pair.port.h.stats.late_read_blocks
    acqs = pair.fulfill(plans, fetched)
    pair.commit(tokens, acqs)
    assert pair.port.h.stats.late_read_blocks - before == spilled
    return DOC


def scenario_streaming(pair: Pair) -> int:
    """(e) A streaming backend: a request whose document is all on the
    device streams nothing; one whose document's tail is on host streams
    from block 0, as before."""
    pair.serve(seq(0, DOC))
    pair.serve(seq(0, DOC, 1, Q))
    assert pair.port.store.streamed == [] and pair.ref.store.streamed == [DOC]
    pair.serve(seq(1, 4))  # the document's tail to host
    tokens = seq(0, DOC, 2, Q)
    assert chain_tiers(pair.port.h, tokens) == [TIER_DEVICE] * 4 + [TIER_HOST] * 2
    pair.serve(tokens)
    assert pair.port.store.streamed == [DOC] and pair.ref.store.streamed == [DOC, DOC]
    assert pair.port.store.got == pair.ref.store.got == []
    return DOC


SCENARIOS = {
    "device_chain": (scenario_device_chain, 16, 16, False),
    "host_tail": (scenario_host_tail, 8, 16, False),
    "disk_tail_and_extension": (scenario_disk_tail_and_extension, 8, 2, False),
    "hole_below_device_run": (scenario_hole_below_device_run, 8, 2, False),
    "spilled_after_plan": (scenario_spilled_after_plan, 8, 2, False),
    "streaming": (scenario_streaming, 8, 16, True),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fetch_skips_device_blocks_and_installs_what_the_reference_does(tmp_path, name):
    fn, device, host, streaming = SCENARIOS[name]
    pair = Pair(tmp_path, device, host, streaming)
    try:
        skipped = fn(pair)
        assert_same_state(pair)
        assert pair.port.h.stats.fetch_skipped_blocks >= skipped
        assert pair.port.read < pair.ref.read
    finally:
        pair.close()


# ------------------------------------------------------------- ranged get
N = 8  # blocks of the stored sequence


def make_store(kind, root):
    """One backend; the memory store holds its blocks unencoded."""
    if kind == "lsm":
        return KVBlockStore(str(root), block_size=B)
    if kind == "sharded":
        return ShardedKVBlockStore(str(root), n_shards=2, block_size=B)
    if kind == "file":
        return FilePerObjectStore(str(root), block_size=B)
    store = MemoryOnlyStore(budget_bytes=1 << 30, block_size=B)
    store.codec = BatchCodec(CODEC_RAW, use_zlib=False)
    return store


def filled(kind, root, hole: Optional[int] = None):
    """A store holding the N blocks of one sequence, but for ``hole``."""
    store = make_store(kind, root)
    tokens = seq(3, N)
    blocks = [block(tokens, i) for i in range(N)]
    if hole is None:
        store.put_batch(tokens, blocks)
    else:
        store.put_batch(tokens, blocks[:hole])
        store.put_batch(tokens, blocks[hole + 1 :], start_block=hole + 1)
    return store, tokens


# (start, hole, blocks expected from start)
RANGES = {
    "from_0": (0, None, N),
    "from_3": (3, None, N - 3),
    "hole_after_start": (2, 5, 3),
    "at_cached_end": (N, None, 0),
    "past_cached_end": (N + 2, None, 0),
    "past_a_hole": (6, 5, 0),  # the full get stops at the hole
}


@pytest.mark.parametrize("kind", ["lsm", "sharded", "file", "memory"])
@pytest.mark.parametrize("case", list(RANGES))
def test_ranged_get_is_the_full_gets_tail(tmp_path, kind, case):
    start, hole, want = RANGES[case]
    store, tokens = filled(kind, tmp_path, hole)
    try:
        full = store.get_batch(tokens, N * B)
        before = store.stats.get_blocks
        trace = TraceContext()
        with activate(trace):
            got = store.get_batch(tokens, N * B, start_block=start)
        assert store.stats.get_blocks - before == len(got) == want
        assert len(got) == len(full[start:])
        assert all(np.array_equal(a, b) for a, b in zip(got, full[start:]))
        codec = getattr(store, "codec", None) or getattr(store, "shards", [None])[0].codec
        for i, g in enumerate(got):  # block start + i, as the store's codec gives it back
            assert np.array_equal(g, BatchCodec.decode(codec.encode(block(tokens, start + i))))
        if kind in ("lsm", "sharded"):
            # read and decoded: only the blocks it returns
            decoded = sum(s.units for s in trace.records if s.name == "store.decode")
            assert decoded == want
    finally:
        if kind != "memory":
            store.close()
