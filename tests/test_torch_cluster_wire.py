"""The port's cache cluster against the reference's on the wire: every
request, response and stream frame of ``repro_torch.cluster.protocol`` is
byte-equal to ``repro.cluster.protocol``'s on the same seeded inputs (and
each decodes the other's); both ``HashRing``s place seeded keys alike, in
steady state and across a membership change; and a port client over
reference servers, a reference client over port servers, and an all-port
against an all-reference cluster return the same answers."""

import numpy as np
import pytest
from torch_cluster_harness import B, blocks, mem_server, seq

from repro.cluster import CacheNodeServer as RefServer
from repro.cluster import ClusterKVBlockStore as RefCluster
from repro.cluster import protocol as RP
from repro.cluster import ring as RR
from repro.core.baselines import MemoryOnlyStore as RefMemoryStore
from repro_torch.cluster import ClusterKVBlockStore
from repro_torch.cluster import protocol as TP
from repro_torch.cluster import ring as TR
from repro_torch.configs import get_config
from repro_torch.core.keycodec import encode_tokens

QWEN = get_config("qwen3-14b")
QWEN_BLOCK = (16, 2 * QWEN.n_layers * QWEN.n_kv_heads * QWEN.d_head)  # the serve hook's stored block, float16


def _qwen_blocks(rng, n):
    return [rng.standard_normal(QWEN_BLOCK).astype(np.float16) for _ in range(n)]


def _requests(rng):
    """(op, args) for every opcode: float16 qwen3-14b blocks for the puts."""
    toks = seq(rng, 3)
    qb = _qwen_blocks(rng, 2)
    keys = [b"k1", b"\x00" * 12, bytes(rng.integers(0, 256, 40, dtype=np.uint8))]
    return {
        RP.OP_PING: (), RP.OP_STATS: (), RP.OP_METRICS: (), RP.OP_FLUSH: (),
        RP.OP_PROBE: (toks,),
        RP.OP_PROBE_MANY: ([toks, toks[:B]],),
        RP.OP_GET: (toks, 8),
        RP.OP_GET_MANY: ([(toks, 8), (toks[:B], 4)],),
        RP.OP_PUT: (toks, qb, 1, False),
        RP.OP_PUT_MANY: ([(toks, qb, 2), (toks[:B], blocks(rng, 1), 0)],),
        RP.OP_MAINTENANCE: (7,),
        RP.OP_GET_STREAM: (toks, 12, 4),
        RP.OP_GET_MANY_STREAM: ([(toks, 12), (toks[:B], 4)], 2),
        RP.OP_SCAN: (b"cur", 256, [(0, 2**63), (2**64 - 5, 17)]),
        RP.OP_PULL: (keys,),
        RP.OP_PUSH: ([(k, i, bytes(rng.integers(0, 256, 9, dtype=np.uint8))) for i, k in enumerate(keys)], True),
    }


def _responses(rng):
    """A success result for every opcode that answers with one RESPONSE."""
    qb = _qwen_blocks(rng, 2)
    return {
        RP.OP_PING: None, RP.OP_FLUSH: None,
        RP.OP_PROBE: 8, RP.OP_PUT: 2,
        RP.OP_PROBE_MANY: [8, 4, 0], RP.OP_PUT_MANY: [2, 0],
        RP.OP_GET: qb,
        RP.OP_GET_MANY: [qb, qb[:1], []],
        RP.OP_STATS: {"put_blocks": 3, "name": "lsm"},
        RP.OP_METRICS: {"metrics": {"gauges": {"repro_server_requests": 4.0}}, "traces": []},
        RP.OP_MAINTENANCE: {"compactions": 1},
        RP.OP_SCAN: ([b"a", b"bb"], b"next"),
        RP.OP_PULL: [(1, b"payload"), None],
        RP.OP_PUSH: 3,
    }


def _same(a, b):
    """Structural equality that holds arrays to dtype, shape and bytes."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and a.tobytes() == b.tobytes())
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def test_the_ports_opcodes_are_the_references():
    assert TP.OP_NAMES == RP.OP_NAMES and TP.MAX_FRAME_BYTES == RP.MAX_FRAME_BYTES == 256 * 1024 * 1024


@pytest.mark.parametrize("op", sorted(RP.OP_NAMES), ids=lambda op: RP.OP_NAMES[op])
def test_request_bytes_match_the_reference(op):
    args = _requests(np.random.default_rng(op))[op]
    ref, port = RP.encode_request(op, *args), TP.encode_request(op, *args)
    assert port == ref
    for decode in (RP.decode_request, TP.decode_request):
        got_op, got = decode(port)
        assert got_op == op and _same(got, args)


@pytest.mark.parametrize("op", sorted(_responses(np.random.default_rng(0))), ids=lambda op: RP.OP_NAMES[op])
def test_response_bytes_match_the_reference(op):
    result = _responses(np.random.default_rng(100 + op))[op]
    ref, port = RP.encode_ok(op, result), TP.encode_ok(op, result)
    assert port == ref
    for decode in (RP.decode_response, TP.decode_response):
        assert _same(decode(op, port), result)


@pytest.mark.parametrize("layout", ["packed", "mixed", "encoded"])
def test_stream_chunk_bytes_match_the_reference(layout):
    """A CHUNK body in each block layout: packed qwen3-14b float16 blocks
    (1), a mixed list (0) and still-encoded codec payloads (3)."""
    from repro.core.codec import BatchCodec

    rng = np.random.default_rng(7)
    if layout == "packed":
        bs = _qwen_blocks(rng, 3)
    elif layout == "mixed":
        bs = blocks(rng, 1) + blocks(rng, 1, dtype=np.float16)
    else:
        bs = [BatchCodec().encode(b) for b in blocks(rng, 2)]
    ref, port = (b"".join(bytes(p) for p in P.encode_stream_chunk(3, 5, bs)) for P in (RP, TP))
    assert port == ref
    want = bs if layout != "encoded" else [BatchCodec.decode(p) for p in bs]
    for P in (RP, TP):
        seq_index, start, got = P.decode_stream_chunk(port)
        assert (seq_index, start) == (3, 5) and _same(got, want)


def test_stream_end_error_and_mux_headers_match_the_reference():
    assert TP.encode_stream_end([4, 0, 2]) == RP.encode_stream_end([4, 0, 2])
    assert TP.decode_stream_end(RP.encode_stream_end([4, 0, 2])) == [4, 0, 2]
    assert TP.encode_error("boom") == RP.encode_error("boom")
    with pytest.raises(TP.RemoteError, match="boom"):
        TP.decode_response(TP.OP_GET, RP.encode_error("boom"))
    trace = bytes(range(8))
    for kind in (TP.KIND_REQUEST, TP.KIND_RESPONSE, TP.KIND_CHUNK, TP.KIND_END):
        assert TP.pack_mux(77, kind, trace) == RP.pack_mux(77, kind, trace)
        assert TP.pack_mux(77, kind) == RP.pack_mux(77, kind)
        rid, k, tr, body = TP.split_mux_ex(RP.pack_mux(77, kind, trace) + b"xy")
        assert (rid, k, tr, bytes(body)) == (77, kind, trace, b"xy")


# ------------------------------------------------------------------ ring
def _keys(n=400):
    rng = np.random.default_rng(11)
    return [seq(rng, 2) for _ in range(n)]


def test_ring_preferences_match_the_reference():
    ids = [f"node-{i}" for i in range(5)]
    ref, port = RR.HashRing(ids), TR.HashRing(ids)
    for toks in _keys():
        assert TR.key_hash(toks, B) == RR.key_hash(toks, B)
        kh = TR.key_hash(toks, B)
        assert port.preference(kh) == ref.preference(kh)
        assert port.preference_ids(kh) == ref.preference_ids(kh)


@pytest.mark.parametrize("change", ["add", "remove"])
def test_ring_transition_sets_match_the_reference(change):
    """Adding or removing a node: the same moved arcs, and for every key
    the same read and write sets, at R 2."""
    old = [f"node-{i}" for i in range(4)]
    new = old + ["node-4"] if change == "add" else old[:1] + old[2:]
    ref = RR.TransitionView(RR.HashRing(old), RR.HashRing(new), 2)
    port = TR.TransitionView(TR.HashRing(old), TR.HashRing(new), 2)
    assert port.moved == ref.moved and port.moved
    assert TR.affected_arcs(TR.HashRing(old), ["node-1"], 2) == RR.affected_arcs(RR.HashRing(old), ["node-1"], 2)
    for toks in _keys():
        kh = TR.key_hash(toks, B)
        assert port.read_ids(kh) == ref.read_ids(kh)
        assert port.write_ids(kh) == ref.write_ids(kh)
        assert port.key_moved(kh) == ref.key_moved(kh)
    key = encode_tokens(list(range(2 * B)))
    assert TR.raw_key_hash(key, B) == RR.raw_key_hash(key, B) == TR.key_hash(list(range(2 * B)), B)


# -------------------------------------------------------------- cross-wire
def _servers(kind, n):
    if kind == "port":
        return [mem_server() for _ in range(n)]
    return [mem_server(RefServer, RefMemoryStore) for _ in range(n)]


def _cluster(kind, servers, replication):
    cls = ClusterKVBlockStore if kind == "port" else RefCluster
    return cls([s.address for s in servers], replication=replication, retries=0, connect_timeout_s=2.0,
               node_ids=[f"node-{i}" for i in range(len(servers))])


@pytest.mark.parametrize("client,server", [("port", "ref"), ("ref", "port")])
def test_a_client_of_one_package_serves_from_nodes_of_the_other(client, server):
    """Puts, probes, gets and their batched forms through one package's
    cluster client over the other package's node servers: every block
    comes back bit for bit, and a one-node cluster of each agrees."""
    servers = _servers(server, 3)
    cluster = _cluster(client, servers, 2)
    try:
        rng = np.random.default_rng(12)
        seqs = [seq(rng, 3) for _ in range(12)]
        payloads = [blocks(rng, 3, dtype=np.float16) for _ in seqs]
        for toks, bs in zip(seqs[:6], payloads[:6]):
            assert cluster.put_batch(toks, bs) == 3
        cluster.put_many([(t, bs, 0) for t, bs in zip(seqs[6:], payloads[6:])])
        assert cluster.probe_many(seqs) == [3 * B] * len(seqs)
        assert [cluster.probe(t) for t in seqs] == [3 * B] * len(seqs)
        got = cluster.get_many([(t, 3 * B) for t in seqs])
        for g, want in zip(got + [cluster.get_batch(t, 2 * B) for t in seqs], payloads + [p[:2] for p in payloads]):
            assert _same(g, want)
        assert cluster.probe(seq(rng, 2)) == 0
    finally:
        cluster.close()
        for s in servers:
            s.close()


def _op_sequence(kind):
    """A seeded sequence of puts, reads, a maintenance cycle, a node's
    death and reads after it, on a 3-node R 2 cluster of one package;
    returns every answer."""
    servers = _servers(kind, 3)
    cluster = _cluster(kind, servers, 2)
    out = []
    try:
        rng = np.random.default_rng(13)
        seqs = [seq(rng, int(rng.integers(1, 4))) for _ in range(16)]
        for step, toks in enumerate(seqs):
            n = len(toks) // B
            out.append(("put", cluster.put_batch(toks, blocks(rng, n), start_block=0)))
            if step % 3 == 0:
                out.append(("probe", cluster.probe(toks[:B] + seq(rng, 1))))
        out.append(("probe_many", cluster.probe_many(seqs)))
        out.append(("get_many", [[b.tobytes() for b in bs] for bs in cluster.get_many([(t, len(t)) for t in seqs])]))
        out.append(("replicas", [cluster.replicas_for(t) for t in seqs]))
        cluster.maintenance(0)
        servers[cluster.replicas_for(seqs[0])[0]].close()
        out.append(("probe_many_degraded", cluster.probe_many(seqs)))
        out.append(("get_degraded", [[b.tobytes() for b in cluster.get_batch(t, len(t))] for t in seqs]))
        out.append(("down", cluster.down_nodes))
        out.append(("replicas_degraded", [cluster.replicas_for(t) for t in seqs]))
    finally:
        cluster.close()
        for s in servers:
            s.close()
    return out


def test_a_seeded_op_sequence_gives_the_same_answers_on_both_packages():
    port, ref = _op_sequence("port"), _op_sequence("ref")
    assert [name for name, _ in port] == [name for name, _ in ref]
    for (name, a), (_, b) in zip(port, ref):
        assert a == b, name
