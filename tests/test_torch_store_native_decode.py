"""The port's LSM store decodes int8 codec payloads in one native call a
chunk (``native/block_decode.py``, ``native/csrc/block_decode.c``): the arrays
are bit for bit what ``BatchCodec.decode`` gives, for int8 with and
without zlib, to f16 and to f32, from bytes and from views into one
buffer; raw and bf16 payloads still take the codec and are not counted;
a corrupt payload raises the codec's own error, the lowest-index one
first; the store counts the blocks and the sharded store sums them; the
library is named by a hash of its source, reused, bound with ctypes, and
built or loaded when a store is constructed, never inside a get."""

import ctypes
import struct
import zlib

import numpy as np
import pytest

from repro_torch.core.codec import (_BFLOAT16, _HDR, CODEC_INT8, CODEC_RAW, HAVE_BFLOAT16, BatchCodec, CodecError,
                                    _split)
from repro_torch.core.sharded_store import ShardedKVBlockStore
from repro_torch.core.store import KVBlockStore
from repro_torch.native import block_decode, build

B = 16  # tokens a block
ZLIB = BatchCodec(CODEC_INT8, use_zlib=True, zlib_level=1)
PLAIN = BatchCodec(CODEC_INT8, use_zlib=False)
SHAPES = {"glm4-block": (B, 20480), "one-row": (1, 2048), "ragged": (5, 13), "3-d": (2, 3, 17)}


@pytest.fixture(scope="module")
def dec():
    return block_decode.load()


def arrays(shape, dtype, seed, n=6):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 3)).astype(dtype) for _ in range(n)]


def as_views(payloads):
    """The payloads as memoryviews into one buffer, each at an odd offset,
    as the tensor log's coalesced read hands them out."""
    buf, spans = bytearray(), []
    for p in payloads:
        buf += b"\x01"
        spans.append((len(buf), len(p)))
        buf += p
    mv = memoryview(bytes(buf))
    return [mv[o : o + n] for o, n in spans]


def outcome(fn):
    try:
        return "ok", fn()
    except CodecError as e:
        return "error", type(e), str(e)


def codec_outcome(payloads):
    return outcome(lambda: [BatchCodec.decode(p) for p in payloads])


def assert_same(got, want):
    """Two outcomes equal: the same error, or the same arrays bit for bit."""
    assert got[0] == want[0], (got, want)
    if got[0] == "error":
        assert got[1:] == want[1:]
        return
    assert len(got[1]) == len(want[1])
    for g, w in zip(got[1], want[1]):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def native(dec, payloads):
    return outcome(lambda: block_decode.decode(dec, payloads)[0])


@pytest.mark.parametrize("form", ["bytes", "views"])
@pytest.mark.parametrize("dtype", [np.float16, np.float32])
@pytest.mark.parametrize("codec", [ZLIB, PLAIN], ids=["int8-zlib", "int8"])
@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_native_decode_equals_the_codec_bit_for_bit(dec, shape, codec, dtype, form):
    payloads = [codec.encode(x) for x in arrays(shape, dtype, seed=hash(shape) % 1000)]
    if form == "views":
        payloads = as_views(payloads)
    got, n_native = block_decode.decode(dec, payloads)
    assert n_native == len(payloads)
    assert_same(("ok", got), codec_outcome(payloads))


def edge_block(case, dtype):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, 64)).astype(np.float32)
    if case == "zero-channel":
        x[:, 5] = 0.0  # its scale is 1.0
        x[:, 40:] = 0.0
    elif case == "f16-subnormal":
        x *= 3e-6  # below f16's smallest normal, 6.1e-5
    elif case == "f16-max":
        x[:, ::2] = np.sign(x[:, ::2]) * 65504.0
        x[0, 1::2] = -65504.0
    else:  # a value scale: 1, 1e-7, 1e-3 or 1e3
        x *= float(case)
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float16, np.float32])
@pytest.mark.parametrize("case", ["zero-channel", "f16-subnormal", "f16-max", "1", "1e-7", "1e-3", "1e3"])
def test_edge_values_decode_as_the_codec_does(dec, case, dtype):
    with np.errstate(over="ignore"):
        x = edge_block(case, dtype)
    payloads = [ZLIB.encode(x), PLAIN.encode(x)]
    got, n_native = block_decode.decode(dec, payloads)
    assert n_native == 2
    assert_same(("ok", got), codec_outcome(payloads))
    if case == "f16-subnormal" and dtype == np.float16:
        h = got[0].view(np.uint16) & 0x7FFF
        assert ((h > 0) & (h < 0x0400)).any()  # f16 subnormals among the results


def with_scales(payload, scale_bits, zlibbed):
    """``payload`` with its int8 scales replaced by ``scale_bits`` (u32),
    its body deflated if ``zlibbed``."""
    codec, zl, shape, dt_code, body = _split(payload)
    head = bytearray(payload[: len(payload) - len(body)])
    head[1] = int(zlibbed)  # the header's zlib flag
    raw = bytearray(zlib.decompress(body) if zl else body)
    raw[: 4 * shape[-1]] = scale_bits.astype("<u4").tobytes()
    return bytes(head) + (zlib.compress(bytes(raw), 1) if zlibbed else bytes(raw))


@pytest.mark.parametrize("zlibbed", [True, False])
def test_any_scale_bits_inf_nan_and_subnormal_included_decode_as_the_codec_does(dec, zlibbed):
    """Scales of every kind, NaN payloads, infinities, f32 subnormals and
    values past f16's range, times every int8 value."""
    rng = np.random.default_rng(11)
    cols = 8 * 37 + 3
    q = np.tile(np.arange(-128, 128, dtype=np.int8), cols)[: 256 * cols].reshape(256, cols)
    special = np.array([0x7F800000, 0xFF800000, 0x7FC00000, 0x7F800001, 0xFFC12345, 0x00000001,
                        0x80000001, 0x007FFFFF, 0x38800000, 0x477FF000, 0x477FE000, 0x33000000,
                        0x33000001, 0x3F800000, 0x0, 0x80000000], dtype=np.uint32)
    payloads = []
    for k in range(4):
        bits = rng.integers(0, 2**32, size=cols, dtype=np.uint64).astype(np.uint32)
        bits[: len(special)] = np.roll(special, k)
        x = np.zeros((256, cols), np.float16 if k % 2 == 0 else np.float32)
        p = PLAIN.encode(x)
        raw = bytearray(p)
        body_at = len(p) - (4 * cols + q.size)
        raw[body_at + 4 * cols :] = q.tobytes()
        payloads.append(with_scales(bytes(raw), bits, zlibbed))
    with np.errstate(all="ignore"):
        want = codec_outcome(payloads)
        got, n_native = block_decode.decode(dec, payloads)
    assert n_native == len(payloads)
    assert_same(("ok", got), want)


def other_payloads():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 96)).astype(np.float16)
    out = {"raw": BatchCodec(CODEC_RAW, use_zlib=False).encode(x),
           "raw-zlib": BatchCodec(CODEC_RAW, use_zlib=True).encode(x),
           "int8-of-int8": ZLIB.encode((rng.integers(-100, 100, size=(B, 96))).astype(np.int8))}
    if HAVE_BFLOAT16:
        out["bf16-int8"] = ZLIB.encode(x.astype(_BFLOAT16))
        out["bf16-raw"] = BatchCodec(CODEC_RAW, use_zlib=True).encode(x.astype(_BFLOAT16))
    return out


@pytest.mark.parametrize("kind", sorted(other_payloads()))
def test_other_payloads_take_the_codec_and_are_not_counted(dec, kind, monkeypatch):
    good = ZLIB.encode(np.ones((B, 96), np.float16))
    payloads = [good, other_payloads()[kind], good]
    calls = []
    real = BatchCodec.decode
    monkeypatch.setattr(BatchCodec, "decode", staticmethod(lambda p: calls.append(bytes(p)) or real(p)))
    got, n_native = block_decode.decode(dec, payloads)
    assert n_native == 2 and calls == [bytes(payloads[1])]
    monkeypatch.undo()
    assert_same(("ok", got), codec_outcome(payloads))


def damaged(kind, zlibbed, where=0.5):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 256)).astype(np.float16)
    p = bytearray((ZLIB if zlibbed else PLAIN).encode(x))
    head = _HDR.size + 4 * 2 + 1
    if kind == "truncated-header":
        return bytes(p[: head - 3])
    if kind == "truncated-body":
        return bytes(p[: head + int((len(p) - head) * where)])
    if kind == "bit-flip":
        i = head + int((len(p) - head) * where)
        p[i] ^= 0x10
        return bytes(p)
    if kind == "trailing-byte":
        return bytes(p) + b"\x00"
    if kind == "wrong-shape":
        struct.pack_into("<I", p, _HDR.size, B + 1)
        return bytes(p)
    if kind == "huge-shape":
        struct.pack_into("<I", p, _HDR.size, 2**32 - 1)
        return bytes(p)
    if kind == "bad-codec":
        p[0] = 9
        return bytes(p)
    raise ValueError(kind)


KINDS = ["truncated-header", "truncated-body", "bit-flip", "trailing-byte", "wrong-shape", "huge-shape", "bad-codec"]


@pytest.mark.parametrize("zlibbed", [True, False], ids=["int8-zlib", "int8"])
@pytest.mark.parametrize("kind", KINDS)
def test_a_damaged_payload_decodes_or_raises_as_the_codec_does(dec, kind, zlibbed):
    """Alone and between good payloads: the same error, type and message,
    or (a byte after a deflate stream, which zlib ignores) the same
    arrays."""
    good = ZLIB.encode(np.full((B, 256), 0.5, np.float16))
    for where in (0.0, 0.3, 0.9):
        bad = damaged(kind, zlibbed, where)
        for payloads in ([bad], [good, bad, good]):
            assert_same(native(dec, payloads), codec_outcome(payloads))


@pytest.mark.parametrize("first, second", [("bit-flip", "bad-codec"), ("wrong-shape", "truncated-body"),
                                           ("bad-codec", "bit-flip"), ("truncated-header", "wrong-shape")])
def test_in_a_mixed_chunk_the_lowest_index_bad_payloads_error_is_raised(dec, first, second):
    good = [ZLIB.encode(x) for x in arrays((B, 256), np.float16, seed=2, n=4)]
    payloads = [good[0], damaged(first, True), good[1], damaged(second, False), good[2]]
    got = native(dec, payloads)
    assert got[0] == "error"
    assert_same(got, outcome(lambda: BatchCodec.decode(payloads[1])))


def tokens(doc, n_blocks):
    return [(97 * doc + 5 * i) % 40009 + 1 for i in range(n_blocks * B)]


def fill(store, doc, n_blocks, dtype=np.float16):
    toks = tokens(doc, n_blocks)
    assert store.put_batch(toks, arrays((B, 512), dtype, seed=doc, n=n_blocks)) == n_blocks
    store.flush()
    return toks


@pytest.mark.timeout(60)
@pytest.mark.parametrize("codec, counted", [(ZLIB, True), (PLAIN, True),
                                            (BatchCodec(CODEC_RAW, use_zlib=False), False)],
                         ids=["int8-zlib", "int8", "raw"])
def test_the_store_counts_the_blocks_the_native_call_decoded(tmp_path, codec, counted):
    st = KVBlockStore(str(tmp_path), block_size=B, codec=codec)
    toks = fill(st, 1, 12)
    got = st.get_batch(toks, len(toks), start_block=2)
    assert st.stats.get_blocks == 10
    assert st.stats.native_decode_blocks == (10 if counted else 0)
    want = [BatchCodec.decode(p) for p in st.get_batch_encoded(toks, len(toks))[2:]]
    assert_same(("ok", got), ("ok", want))
    st.close()


@pytest.mark.timeout(60)
def test_the_sharded_store_sums_the_native_count_over_its_shards(tmp_path):
    st = ShardedKVBlockStore(str(tmp_path), n_shards=4, block_size=B, codec=ZLIB)
    sizes = [3, 7, 1, 9, 4]
    seqs = [fill(st, 40 + d, n) for d, n in enumerate(sizes)]
    for t in seqs:
        st.get_batch(t, len(t))
    per_shard = [s.stats.native_decode_blocks for s in st.shards]
    assert st.stats.native_decode_blocks == sum(per_shard) == sum(sizes)
    assert sum(1 for n in per_shard if n) > 1
    st.close()


def test_the_library_is_named_by_its_source_hash_and_bound_with_ctypes(dec):
    assert dec is block_decode.load()
    assert dec.path == block_decode.library_path() and dec.path.exists()
    assert dec.path.parent == block_decode.BUILD_DIR
    assert type(dec.lib) is ctypes.CDLL  # not PyDLL: a call releases the GIL
    assert dec.entry._flags_ & ctypes._FUNCFLAG_PYTHONAPI == 0
    assert dec.entry.__name__ == "block_decode_int8"


@pytest.mark.timeout(120)
def test_an_edited_source_builds_a_new_library_and_an_unchanged_one_is_reused(tmp_path, monkeypatch):
    src = tmp_path / "block_decode.c"
    src.write_bytes(block_decode.SOURCE.read_bytes())
    monkeypatch.setattr(block_decode, "SOURCE", src)
    monkeypatch.setattr(block_decode, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(block_decode, "_loaded", None)
    first = block_decode.load()
    built = first.path.stat().st_mtime_ns
    monkeypatch.setattr(block_decode, "_loaded", None)
    monkeypatch.setattr(build, "_libs", {})  # as a fresh process finds it: the file on disk alone
    monkeypatch.setattr(build.subprocess, "Popen", lambda *a, **k: pytest.fail("rebuilt an unchanged source"))
    again = block_decode.load()
    assert again.path == first.path and again.path.stat().st_mtime_ns == built
    monkeypatch.undo()
    monkeypatch.setattr(block_decode, "SOURCE", src)
    monkeypatch.setattr(block_decode, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(block_decode, "_loaded", None)
    src.write_bytes(src.read_bytes() + b"\n/* edited */\n")
    edited = block_decode.load()
    assert edited.path != first.path and edited.path.exists()
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted([first.path.name, edited.path.name])
    monkeypatch.undo()


def test_a_host_without_a_compiler_cannot_construct_a_store(tmp_path, monkeypatch):
    monkeypatch.setattr(block_decode, "_loaded", None)
    monkeypatch.setattr(block_decode.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C compiler"):
        KVBlockStore(str(tmp_path), block_size=B, codec=ZLIB)


@pytest.mark.timeout(60)
def test_a_get_never_builds_or_loads_the_library(tmp_path, monkeypatch):
    st = KVBlockStore(str(tmp_path), block_size=B, codec=ZLIB)
    toks = fill(st, 3, 6)

    def refuse(*args, **kwargs):
        raise AssertionError("built or loaded inside a get")

    for name in ("load", "library_path", "compiler", "load_library"):
        monkeypatch.setattr(block_decode, name, refuse)
    for name in ("build_libraries", "load_library"):
        monkeypatch.setattr(build, name, refuse)
    got = st.get_batch(toks, len(toks))
    assert len(got) == 6 and st.stats.native_decode_blocks == 6
    st.close()


def test_a_shape_its_body_cannot_hold_never_reaches_the_native_call(dec):
    """Sizes are checked before the call (``need`` there can neither
    overflow nor outgrow the output): such a payload goes to the codec,
    which names the fault."""

    class Spy:
        uncompress = dec.uncompress
        seen = []

        def entry(self, n, *args):
            self.seen.append(n)
            return dec.entry(n, *args)

    good = ZLIB.encode(np.ones((B, 8), np.float16))
    for zlibbed in (True, False):
        spy = Spy()
        payloads = [good, damaged("huge-shape", zlibbed), good]
        assert_same(outcome(lambda: block_decode.decode(spy, payloads)[0]), codec_outcome(payloads))
        assert spy.seen == [2]
        Spy.seen = []


@pytest.mark.timeout(60)
def test_a_failed_build_raises_naming_the_compiler_and_leaves_no_file(tmp_path):
    src = tmp_path / "broken.c"
    src.write_text("int broken(void) { return }\n")
    cc = block_decode.compiler()
    out = build.library_file(tmp_path / "build", "broken", src.read_bytes())
    with pytest.raises(RuntimeError, match=r"failed for broken \(exit"):
        build.load_library("broken", out, lambda tmp: [cc, "-shared", "-fPIC", "-o", str(tmp), str(src)])
    assert not out.exists() and list((tmp_path / "build").iterdir()) == []
