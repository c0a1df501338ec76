"""The port's cache-node process and its observability endpoints:
``spawn_local_node`` runs ``python -m repro_torch.cluster.node`` (never the
reference's node), the node serves with ``jax``, ``repro`` and ``torch``
unimportable, its ``--metrics-port`` answers with Prometheus text, a trace
id set in the port's client reaches the node's scrape, a dead node scrapes
as unreachable, and the port's metric catalog names what the reference's
does, and the port's two cache-fetch counters and its decode-pool counter
besides."""

import os
import subprocess
import sys
import textwrap
import urllib.request
from pathlib import Path

import numpy as np
import pytest
from torch_cluster_harness import B, blocks, seq, spawn_nodes

from repro.obs import catalog as ref_catalog
from repro_torch.cluster import ClusterKVBlockStore, NodeUnavailable, RemoteKVBlockStore, spawn_local_node
from repro_torch.obs import TraceContext, activate
from repro_torch.obs import catalog

SRC = Path(__file__).resolve().parents[1] / "src"
BLOCKED = ("jax", "jaxlib", "repro", "torch")


# ``CacheStats`` fields of the port's own cache hierarchy and the ``StoreStats``
# field of its own store, bridged like the rest
PORT_GAUGES = ["repro_cache_fetch_skipped_blocks", "repro_cache_late_read_blocks",
               "repro_store_pooled_decode_blocks"]


def test_the_catalog_names_what_the_references_does():
    assert catalog.all_names() == sorted(ref_catalog.all_names() + PORT_GAUGES)
    want = ref_catalog.catalog()
    want["gauges"] = sorted(want["gauges"] + PORT_GAUGES)
    assert catalog.catalog() == want
    assert [p for p, _ in catalog.stats_bridges()] == [p for p, _ in ref_catalog.stats_bridges()]
    assert all(cls.__module__.startswith("repro_torch.") for _, cls in catalog.stats_bridges())


@pytest.fixture(scope="module")
def metrics_node(tmp_path_factory):
    (node,) = spawn_nodes(tmp_path_factory.mktemp("torchobsnode"), 1, block_size=16, backend="lsm",
                          metrics_port=0)
    yield node
    node.close()


def test_spawn_local_node_runs_the_ports_node(metrics_node):
    args = metrics_node.proc.args
    i = args.index("-m")
    assert args[i + 1] == "repro_torch.cluster.node" and metrics_node.alive


def test_node_http_exposition(metrics_node):
    """--metrics-port serves the node's registry as Prometheus text, with
    the server's counters and the per-op latency histograms."""
    assert metrics_node.metrics_port
    remote = RemoteKVBlockStore(metrics_node.address, block_size=16, retries=0)
    try:
        assert remote.ping()
    finally:
        remote.close()
    url = f"http://127.0.0.1:{metrics_node.metrics_port}/metrics"
    with urllib.request.urlopen(url, timeout=10) as resp:
        assert resp.headers["Content-Type"].startswith("text/plain")
        text = resp.read().decode()
    assert "# TYPE repro_node_request_seconds histogram" in text
    assert "repro_server_requests" in text and "repro_node_request_seconds_p99" in text


def test_trace_id_propagates_to_node_scrape(metrics_node):
    """A trace activated around the port client's RPCs crosses the wire:
    the port node's OP_METRICS report carries the trace id and a
    server-side span for each traced request, and untraced RPCs add none."""
    store = ClusterKVBlockStore([metrics_node.address], block_size=16)
    try:
        tr = TraceContext()
        tokens = list(range(1000, 1032))
        bs = [np.ones((16, 8), dtype=np.float32)] * 2
        with activate(tr):
            store.put_batch(tokens, bs, start_block=0)
            store.flush()
            got = store.get_batch(tokens, 32)
        assert len(got) == 2 and all(np.array_equal(g, b) for g, b in zip(got, bs))
        m = store.nodes[0].metrics()
        assert tr.trace_id in m["traces"]
        assert m["metrics"]["histograms"]["repro_node_trace_server_span_seconds"]["count"] >= 3
        traced = m["metrics"]["counters"]["repro_node_trace_requests_total"]
        assert traced >= 3
        store.probe(tokens)
        assert store.nodes[0].metrics()["metrics"]["counters"]["repro_node_trace_requests_total"] == traced
    finally:
        store.close()


def test_scrape_reports_a_killed_port_node_unreachable(tmp_path):
    nodes = spawn_nodes(tmp_path, 2, block_size=16, backend="lsm")
    store = ClusterKVBlockStore([n.address for n in nodes], block_size=16, retries=0, timeout_s=10.0)
    try:
        nodes[1].kill()
        scrape = store.scrape_cluster()
        assert scrape["nodes"][1].get("unreachable") and not scrape["nodes"][0].get("unreachable")
        assert 1 in scrape["down"] and 0 in scrape["live"]
        assert store.scrape_cluster()["nodes"][1].get("unreachable")
    finally:
        store.close()
        for n in nodes:
            n.close()


def _blocker(tmp_path) -> Path:
    """A directory whose ``sitecustomize`` makes BLOCKED unimportable in
    every interpreter started with it on PYTHONPATH."""
    d = tmp_path / "blocker"
    d.mkdir()
    (d / "sitecustomize.py").write_text("import sys\n" + "".join(f"sys.modules[{n!r}] = None\n" for n in BLOCKED))
    return d


def test_a_port_node_serves_with_jax_repro_and_torch_unimportable(tmp_path, monkeypatch):
    """The node is a storage process: started through spawn_local_node
    with jax, repro and torch blocked at interpreter start, it binds, takes
    a put and answers a get bit for bit, and dies by SIGKILL as a client
    sees it."""
    blocker = _blocker(tmp_path)
    monkeypatch.setenv("PYTHONPATH", str(blocker))
    for name in BLOCKED:  # the blocker works: each import fails in such an interpreter
        out = subprocess.run([sys.executable, "-c", f"import {name}"], capture_output=True, text=True,
                             env=dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{blocker}"), timeout=60)
        assert out.returncode != 0 and "ModuleNotFoundError" in out.stderr, name
    node = spawn_local_node(str(tmp_path / "n0"), block_size=B, codec="raw", io_threads=1,
                            ready_timeout_s=120.0)
    try:
        remote = RemoteKVBlockStore(node.address, retries=1, timeout_s=10.0)
        rng = np.random.default_rng(11)
        toks, bs = seq(rng, 2), blocks(rng, 2, dtype=np.float16)
        assert remote.put_batch(toks, bs) == 2
        got = remote.get_batch(toks, 2 * B)
        assert all(g.dtype == b.dtype and g.tobytes() == b.tobytes() for g, b in zip(got, bs))
        node.kill()
        with pytest.raises(NodeUnavailable):
            remote.probe(toks)
        remote.close()
    finally:
        node.close()


def test_the_node_module_imports_with_jax_repro_and_torch_blocked():
    """In-process form of the same: the node's module and the whole
    cluster package import with the three blocked, and pull in none."""
    code = textwrap.dedent(f"""
        import sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        import repro_torch.cluster, repro_torch.cluster.node, repro_torch.obs.httpd, repro_torch.obs.catalog
        assert not any(k.split(".")[0] in {BLOCKED!r} for k in sys.modules if sys.modules[k] is not None)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(SRC)), timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-1] == "ok"
