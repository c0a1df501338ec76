"""The port's ``KVBlockStore.get_batch`` decodes a large get's blocks in
parallel on the process's shared decode pool: the arrays are bit for bit
and in order what a serial ``BatchCodec.decode`` loop gives over the same
payloads, a one-block get stays on the caller while two blocks already
split, a corrupt record raises the error
the serial loop would raise first, gets run from a busy ``IOExecutor``
finish, the sharded store sums the counter, and a forked child decodes
with a pool of its own."""

import os
import struct
import sys
import threading
import time
import zlib

import numpy as np
import pytest

from repro_torch.core import store as store_mod
from repro_torch.core.codec import CODEC_INT8, BatchCodec, CodecError
from repro_torch.core.sharded_store import ShardedKVBlockStore
from repro_torch.core.store import DECODE_MAX_WORKERS, KVBlockStore
from repro_torch.runtime.executor import IOExecutor

B = 16  # tokens a block
GLM4_BLOCK = (B, 20480)  # glm4-9b: 40 layers × k, v × 2 KV heads × 128, f16
SMALL_BLOCK = (B, 2048)
CODEC = BatchCodec(CODEC_INT8, use_zlib=True, zlib_level=1)
_REC_HDR = struct.Struct("<III")  # tensor-log record: crc | klen | plen


def tokens(doc: int, n_blocks: int):
    return [(131 * doc + 7 * i) % 50021 + 1 for i in range(n_blocks * B)]


def fill(store, doc: int, n_blocks: int, shape=SMALL_BLOCK):
    rng = np.random.default_rng(1000 + doc)
    toks = tokens(doc, n_blocks)
    blocks = [rng.standard_normal(shape).astype(np.float16) for _ in range(n_blocks)]
    assert store.put_batch(toks, blocks) == n_blocks
    store.flush()
    return toks


def lsm(root) -> KVBlockStore:
    return KVBlockStore(str(root), block_size=B, codec=CODEC)


def width() -> int:
    return max(1, min(DECODE_MAX_WORKERS, len(os.sched_getaffinity(0))))


def pooled(m: int, w: int = None) -> int:
    """Blocks of an ``m``-block get that the pool decodes: all but the
    caller's chunk, the first of ``min(w, m)`` contiguous ones."""
    w = width() if w is None else w
    return m - m // min(w, m)


def serial(store, toks, n_tokens, start_block=0):
    return [BatchCodec.decode(p) for p in store.get_batch_encoded(toks, n_tokens)[start_block:]]


def assert_bits_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint16), w.view(np.uint16))


@pytest.fixture(scope="module")
def glm4_store(tmp_path_factory):
    st = lsm(tmp_path_factory.mktemp("decodepool"))
    toks = fill(st, 0, 40, GLM4_BLOCK)
    yield st, toks
    st.close()


@pytest.fixture
def decode_cpus(monkeypatch):
    """Rebuild the shared pool as if the process could run on ``n`` CPUs;
    the pool goes back to the host's width afterwards."""

    def _set(n: int):
        monkeypatch.setattr(store_mod, "_usable_cpus", lambda: n)
        _reset()

    def _reset():
        pool = store_mod._decode_pool
        store_mod._drop_decode_pool()
        if pool is not None:
            pool.shutdown(wait=True)

    yield _set
    monkeypatch.undo()
    _reset()


@pytest.mark.timeout(120)
@pytest.mark.parametrize("start_block", [0, 7, 39])
def test_large_get_equals_the_serial_decode_bit_for_bit_and_in_order(glm4_store, start_block):
    st, toks = glm4_store
    before = st.stats.pooled_decode_blocks
    got = st.get_batch(toks, len(toks), start_block=start_block)
    assert_bits_equal(got, serial(st, toks, len(toks), start_block))
    assert st.stats.pooled_decode_blocks - before == pooled(40 - start_block)


@pytest.mark.timeout(60)
@pytest.mark.parametrize("n_blocks", [1, 2, 3])
def test_a_small_get_leaves_the_caller_one_block(tmp_path, n_blocks):
    """One block never leaves the caller; two or three split a block a
    decoder wherever the host has the cores."""
    st = lsm(tmp_path)
    toks = fill(st, 1, n_blocks)
    got = st.get_batch(toks, len(toks))
    want_pooled = 0 if n_blocks == 1 else pooled(n_blocks)
    assert st.stats.pooled_decode_blocks == want_pooled and st.stats.get_blocks == n_blocks
    assert_bits_equal(got, serial(st, toks, len(toks)))
    st.close()


def corrupt(store, toks, n_blocks: int, i: int, how: str) -> None:
    """Rewrite block ``i``'s record in the log in place, with a valid CRC,
    so that the read passes and the decode fails: ``zlib`` breaks the
    deflate stream's header, ``codec`` the payload's codec byte."""
    ptr = store._scan_block_ptrs(toks, n_blocks)[i]
    path = store.log._path(ptr.file_id)
    with open(path, "r+b") as f:
        f.seek(ptr.offset)
        rec = bytearray(f.read(ptr.length))
        _, klen, plen = _REC_HDR.unpack_from(rec)
        payload = _REC_HDR.size + klen
        if how == "zlib":
            body = payload + 4 + 4 * 2 + 1  # after the codec header of a 2-d block
            rec[body : body + 2] = b"\x00\x00"
        else:
            rec[payload] = 7
        crc = zlib.crc32(rec[_REC_HDR.size : _REC_HDR.size + klen + plen]) & 0xFFFFFFFF
        struct.pack_into("<I", rec, 0, crc)
        f.seek(ptr.offset)
        f.write(rec)


@pytest.mark.timeout(60)
@pytest.mark.parametrize("bad", [(3,), (17,), (0, 17), (17, 28)])
def test_a_corrupt_record_raises_the_serial_loops_first_error(tmp_path, bad):
    """The first bad record is zlib-corrupt, any later one has an unknown
    codec code: the error raised names the first, wherever its chunk ran."""
    st = lsm(tmp_path)
    toks = fill(st, 2, 32)
    for j, i in enumerate(bad):
        corrupt(st, toks, 32, i, "zlib" if j == 0 else "codec")
    with pytest.raises(CodecError, match="corrupt zlib body"):
        st.get_batch(toks, len(toks))
    assert st.stats.get_blocks == 0 and st.stats.pooled_decode_blocks == 0
    # a get that starts past the bad records decodes as before
    tail = st.get_batch(toks, len(toks), start_block=max(bad) + 1)
    assert len(tail) == 31 - max(bad)
    st.close()


@pytest.mark.timeout(60)
def test_gets_from_a_busy_io_executor_do_not_deadlock(tmp_path):
    """8 concurrent gets on a 4-thread IOExecutor: every slot busy, each
    get's chunks on the one decode pool."""
    st = lsm(tmp_path)
    seqs = [fill(st, 10 + d, 12) for d in range(8)]
    ex = IOExecutor(max_workers=4)
    try:
        futs = [ex.submit(st.get_batch, t, len(t)) for t in seqs]
        got = [f.result(timeout=50) for f in futs]
    finally:
        ex.close()
    for t, g in zip(seqs, got):
        assert_bits_equal(g, serial(st, t, len(t)))
    assert st.stats.pooled_decode_blocks == 8 * pooled(12)
    st.close()


@pytest.mark.timeout(60)
def test_more_getting_threads_than_cores_lose_no_count(tmp_path):
    """Twice as many threads as cores, each making gets of 4-9 blocks with
    a short switch interval: every array right, no pooled block uncounted."""
    st = lsm(tmp_path)
    sizes = [4 + d % 6 for d in range(6)]
    seqs = [fill(st, 30 + d, n) for d, n in enumerate(sizes)]
    want = [serial(st, t, len(t)) for t in seqs]
    before = st.stats.pooled_decode_blocks
    n_threads, rounds = 2 * (os.cpu_count() or 1), 3
    errors = []

    def work(k: int):
        try:
            for r in range(rounds):
                i = (k + r) % len(seqs)
                assert_bits_equal(st.get_batch(seqs[i], len(seqs[i])), want[i])
        except BaseException as e:  # noqa: BLE001 — reported by the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=50)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    expect = sum(pooled(sizes[(k + r) % len(seqs)]) for k in range(n_threads) for r in range(rounds))
    assert st.stats.pooled_decode_blocks - before == expect
    st.close()


@pytest.mark.timeout(60)
def test_the_sharded_store_sums_the_counter_over_its_shards(tmp_path):
    st = ShardedKVBlockStore(str(tmp_path), n_shards=4, block_size=B, codec=CODEC)
    sizes = [5, 9, 2, 14, 6, 11]
    seqs = [fill(st, 20 + d, n) for d, n in enumerate(sizes)]
    assert len({id(st.shard_for(t)) for t in seqs}) > 1
    for t in seqs:
        assert_bits_equal(st.get_batch(t, len(t)), serial(st, t, len(t)))
    per_shard = [s.stats.pooled_decode_blocks for s in st.shards]
    assert st.stats.pooled_decode_blocks == sum(per_shard) == sum(pooled(n) for n in sizes)
    assert sum(1 for n in per_shard if n) > 1
    st.close()


@pytest.mark.timeout(60)
@pytest.mark.parametrize("cpus, want_width", [(1, 1), (2, 2), (5, 5), (64, DECODE_MAX_WORKERS)])
def test_the_pool_is_as_wide_as_the_usable_cpus_up_to_the_cap(tmp_path, decode_cpus, cpus, want_width):
    decode_cpus(cpus)
    st = lsm(tmp_path)
    toks = fill(st, 3, 10)
    got = st.get_batch(toks, len(toks))
    assert_bits_equal(got, serial(st, toks, len(toks)))
    assert st.stats.pooled_decode_blocks == pooled(10, want_width)
    pool = store_mod._decode_pool
    assert (pool is None) if want_width == 1 else (pool._max_workers == want_width - 1)
    st.close()


@pytest.mark.timeout(60)
@pytest.mark.skipif(not hasattr(os, "fork"), reason="no os.fork on this platform")
def test_a_forked_child_decodes_on_a_pool_of_its_own(tmp_path):
    st = lsm(tmp_path)
    toks = fill(st, 4, 12)
    want = serial(st, toks, len(toks))
    assert_bits_equal(st.get_batch(toks, len(toks)), want)
    parent_pool = store_mod._decode_pool
    assert parent_pool is not None or width() == 1
    pid = os.fork()
    if pid == 0:  # the child: exit 0 only if its get is right
        code = 1
        try:
            got = st.get_batch(toks, len(toks))
            same = all(np.array_equal(g.view(np.uint16), w.view(np.uint16)) for g, w in zip(got, want))
            fresh = store_mod._decode_pool is not parent_pool or parent_pool is None
            code = 0 if same and len(got) == len(want) and fresh else 1
        finally:
            os._exit(code)
    deadline = time.monotonic() + 45
    while True:
        done, status = os.waitpid(pid, os.WNOHANG)
        if done:
            break
        if time.monotonic() > deadline:
            os.kill(pid, 9)
            os.waitpid(pid, 0)
            pytest.fail("the forked child's get_batch hung")
        time.sleep(0.05)
    assert os.WIFEXITED(status) and os.WEXITSTATUS(status) == 0
    st.close()
