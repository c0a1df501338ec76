"""Cluster fault tolerance end-to-end: a 3-node cache cluster serves a
real workload through the unchanged ``ServingEngine``; one node is
SIGKILLed mid-workload; serving degrades but stays *correct* (zero
committed blocks lost — every read fails over to the surviving replica);
the node rejoins on the same address and the ring rebalances back.

The engine and hierarchy never learn any of this happened: the cluster
store is just another ``StorageBackend``.

The per-node numbers printed at the end come from the observability
layer: ``cluster.scrape_cluster()`` fans ``OP_METRICS`` out to every
node and returns each node's full metrics snapshot (counters, gauges,
latency histograms).  The same scrape is exercised *while the victim is
down* — a dead node must come back as ``unreachable`` immediately, not
hang the scrape.

The PyTorch port's copy of ``examples/failover.py``: the same workload
and assertions through ``repro_torch``, over nodes that run
``python -m repro_torch.cluster.node``.  Like the reference, it touches no
device.

    PYTHONPATH=src python examples/failover_torch.py
"""

import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.cache.hierarchy import CacheHierarchy  # noqa: E402
from repro_torch.cluster import ClusterKVBlockStore, spawn_local_node  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serving import ComputeModel, ServingEngine  # noqa: E402
from repro_torch.workload import StagedWorkload  # noqa: E402

BLOCK = 16
PROMPT = 256
N_NODES = 3
REPLICATION = 2


def make_engine(cluster: ClusterKVBlockStore) -> ServingEngine:
    h = CacheHierarchy(BLOCK, device_budget_blocks=64, host_budget_blocks=128,
                       store=cluster)
    return ServingEngine(h, ComputeModel(get_config("glm4-9b")),
                         kv_bytes_per_token=512, tracing=True)


def hit(recs) -> float:
    return float(np.mean([r.reused_tokens / r.prompt_len for r in recs]))


def main():
    work = tempfile.mkdtemp(prefix="failover_")
    print(f"[cluster] spawning {N_NODES} local cache-node processes ...")
    nodes = [
        spawn_local_node(f"{work}/node_{i}", block_size=BLOCK, codec="raw",
                         io_threads=2)
        for i in range(N_NODES)
    ]
    cluster = ClusterKVBlockStore(
        [n.address for n in nodes], replication=REPLICATION, io_threads=2,
        retries=1, timeout_s=20.0,
    )
    print(f"[cluster] up: {[n.address for n in nodes]}, replication={REPLICATION}")
    engine = make_engine(cluster)

    wl = StagedWorkload(prompt_len=PROMPT, requests_per_stage=24,
                        stages=(0.7, 0.7), block_size=BLOCK, corpus_size=8, seed=0)

    # --- phase 1: warm the corpus through the engine, serve stage 0 -------
    warm_prompts = list(wl.warmup_prompts(8 * PROMPT))
    for p in warm_prompts:
        engine.submit(type("R", (), {"tokens": p, "rid": -1, "stage": -1})())
    engine.run()
    recs = []
    for r in wl.stage_requests(0):
        engine.submit(r)
    recs.extend(engine.run())
    engine.drain()  # settle write-behind: everything below counts as committed
    committed = {i: cluster.probe(p) for i, p in enumerate(warm_prompts)}
    print(f"[phase 1] served {len(recs)} requests over 3 nodes, "
          f"hit {hit(recs):.2f}; committed prefixes on cluster: "
          f"{sum(v // BLOCK for v in committed.values())} blocks")

    # --- phase 2: SIGKILL one node mid-workload ---------------------------
    victim = cluster.replicas_for(warm_prompts[0])[0]
    print(f"[phase 2] SIGKILL node {victim} ({nodes[victim].address}) ...")
    nodes[victim].kill()
    recs2 = []
    for r in wl.stage_requests(1):
        engine.submit(r)
    recs2.extend(engine.run())
    engine.drain()
    lost = sum(1 for i, p in enumerate(warm_prompts)
               if cluster.probe(p) < committed[i])
    cs = cluster.cluster_stats
    print(f"[phase 2] served {len(recs2)} requests degraded "
          f"(down={cluster.down_nodes}), hit {hit(recs2):.2f}; "
          f"failover reads: {cs.failovers}, degraded reads: {cs.degraded_reads}")
    print(f"[phase 2] lost committed blocks after kill: {lost}")
    assert lost == 0, "replication=2 must survive a single node kill"
    assert hit(recs2) >= 0.5, "degraded cluster must keep serving cached prefixes"

    # scraping a cluster with a dead member must return immediately with
    # the victim flagged unreachable — never hang on the corpse
    t0 = time.perf_counter()
    degraded = cluster.scrape_cluster()
    scrape_s = time.perf_counter() - t0
    assert degraded["nodes"][victim].get("unreachable"), \
        "dead node must be reported unreachable in the scrape"
    assert all(not degraded["nodes"][i].get("unreachable")
               for i in range(N_NODES) if i != victim)
    assert scrape_s < 5.0, f"scrape must not hang on a dead node ({scrape_s:.1f}s)"
    print(f"[phase 2] mid-outage scrape in {1e3 * scrape_s:.1f}ms: "
          f"node {victim} unreachable, "
          f"{len(degraded['live'])} live nodes still reporting")

    # --- phase 3: rejoin on the same address; ring rebalances -------------
    host, port = nodes[victim].address
    shutil.rmtree(nodes[victim].root, ignore_errors=True)  # cold restart
    nodes[victim] = spawn_local_node(f"{work}/node_{victim}", port=port,
                                     block_size=BLOCK, codec="raw", io_threads=2)
    revived = cluster.maintenance(0)["revived"]  # maintenance pings down nodes
    print(f"[phase 3] node {victim} rejoined on {nodes[victim].address}: "
          f"revived={revived}, live={cluster.live_nodes}")
    assert revived == [victim] and not cluster.down_nodes
    recs3 = []
    for r in wl.stage_requests(0):  # replay stage 0 against the healed ring
        engine.submit(r)
    recs3.extend(engine.run())
    engine.drain()
    still_lost = sum(1 for i, p in enumerate(warm_prompts)
                     if cluster.probe(p) < committed[i])
    print(f"[phase 3] healed cluster served {len(recs3)} requests, "
          f"hit {hit(recs3):.2f}; lost committed blocks: {still_lost} "
          f"(cold rejoined replica is backstopped by best-of-replica reads)")
    assert still_lost == 0

    # --- final STATS: one scrape of the healed cluster --------------------
    scrape = cluster.scrape_cluster()
    assert scrape["down"] == [], "healed cluster must scrape clean"
    cg = scrape["cluster"]["gauges"]
    print(f"[metrics] cluster: rpcs={cg.get('repro_rpc_rpcs', 0):.0f}, "
          f"chunks={cg.get('repro_rpc_stream_chunks', 0):.0f}, "
          f"failovers={cg.get('repro_cluster_failovers', 0):.0f}, "
          f"live={cg.get('repro_cluster_live', 0):.0f}/"
          f"{cg.get('repro_cluster_nodes', 0):.0f}")
    traced_total = 0
    for i, nd in sorted(scrape["nodes"].items()):
        m = nd["metrics"]
        g = m["gauges"]
        hreq = m["histograms"]["repro_node_request_seconds"]
        traced = m["counters"].get("repro_node_trace_requests_total", 0)
        traced_total += traced
        print(f"[metrics] node {i} ({nd['name']}): "
              f"requests={g['repro_server_requests']:.0f}, "
              f"get_blocks={g['repro_store_get_blocks'] + g.get('repro_store_raw_get_blocks', 0):.0f}, "
              f"put_blocks={g['repro_store_put_blocks']:.0f}, "
              f"disk={g.get('repro_node_disk_bytes', 0):.0f} B "
              f"in {g.get('repro_node_file_count', 0):.0f} files, "
              f"req p50/p99={1e3 * hreq['p50']:.2f}/{1e3 * hreq['p99']:.2f} ms, "
              f"traced={traced:.0f}")
        assert g["repro_server_requests"] > 0 and hreq["count"] > 0
    # the engine ran with tracing on: its trace ids crossed the wire and
    # were closed out server-side on the nodes
    assert traced_total > 0, "engine-issued traces must reach the nodes"
    cluster.close()
    for n in nodes:
        n.close()
    shutil.rmtree(work, ignore_errors=True)
    print("ok — zero committed blocks lost across kill and rejoin")


if __name__ == "__main__":
    main()
