"""Failover and elastic membership on the port's nodes, the scenarios of
the reference's cluster suite: a node killed mid-get loses no committed
block, a rejoined node is revived and resumes its arcs, an added node is
filled within one maintenance cycle, a removed node drains and retires, a
death is repaired back to full replication, and a SIGKILL of a
migration's source between steps loses nothing (child processes running
``python -m repro_torch.cluster.node``)."""

import numpy as np
import pytest
from torch_cluster_harness import B, add_mem_node, blocks, close_all, mem_cluster, mem_server, seq, spawn_nodes

from repro_torch.cluster import ClusterKVBlockStore


def test_kill_server_mid_get_fails_over_with_zero_loss():
    servers, cluster = mem_cluster(3, replication=2)
    try:
        rng = np.random.default_rng(8)
        seqs = [seq(rng, 2) for _ in range(30)]
        payloads = {}
        for i, toks in enumerate(seqs):
            payloads[i] = blocks(rng, 2)
            cluster.put_batch(toks, payloads[i])
        victim = cluster.replicas_for(seqs[0])[0]
        servers[victim].close()
        for i, toks in enumerate(seqs):
            assert cluster.probe(toks) == 2 * B, f"lost blocks of seq {i}"
            got = cluster.get_batch(toks, 2 * B)
            assert all(np.array_equal(a, b) for a, b in zip(got, payloads[i]))
        assert victim in cluster.down_nodes and cluster.cluster_stats.failovers > 0
        assert cluster.probe_many(seqs) == [2 * B] * len(seqs)
        got = cluster.get_many([(t, 2 * B) for t in seqs])
        assert all(all(np.array_equal(a, b) for a, b in zip(g, payloads[i])) for i, g in enumerate(got))
        toks = seq(rng, 2)
        cluster.put_batch(toks, blocks(rng, 2))
        assert len(cluster.replicas_for(toks)) == 2 and victim not in cluster.replicas_for(toks)
    finally:
        close_all(cluster, servers)


def test_rejoin_rebalances_back():
    servers, cluster = mem_cluster(3, replication=2)
    try:
        rng = np.random.default_rng(9)
        seqs = [seq(rng, 2) for _ in range(16)]
        for toks in seqs:
            cluster.put_batch(toks, blocks(rng, 2))
        victim = cluster.replicas_for(seqs[0])[0]
        address = servers[victim].address
        servers[victim].close()
        assert cluster.probe(seqs[0]) == 2 * B
        assert victim in cluster.down_nodes
        servers[victim] = mem_server(port=address[1])  # cold restart on the same address
        assert victim in cluster.maintenance(0)["revived"] and cluster.down_nodes == []
        probe_keys = seqs + [seq(rng, 2) for _ in range(64)]
        assert any(victim in cluster.replicas_for(t) for t in probe_keys)
        assert cluster.probe_many(seqs) == [2 * B] * len(seqs)
    finally:
        close_all(cluster, servers)


def test_add_node_rebalances_within_one_maintenance_cycle():
    servers, cluster = mem_cluster(2, replication=2, node_ids=["node-0", "node-1"])
    try:
        rng = np.random.default_rng(21)
        seqs = [seq(rng, 3) for _ in range(32)]
        for toks in seqs:
            cluster.put_batch(toks, blocks(rng, 3))
        for i in (2, 3):
            cluster.add_node(add_mem_node(servers).address, node_id=f"node-{i}")
        assert cluster.in_transition
        assert cluster.probe_many(seqs) == [3 * B] * len(seqs)
        rep = cluster.maintenance(0)
        assert rep["migration"]["done"] and not cluster.in_transition
        ms = cluster.migrator.stats
        assert ms.migrations_completed == 1 and ms.blocks_copied > 0 and ms.rebalance_s > 0
        for toks in seqs:
            for idx in cluster.replicas_for(toks):
                assert cluster.nodes[idx].probe(toks) == 3 * B
        copied = ms.blocks_copied
        assert cluster.maintenance(0)["migration"] == {"active": False}
        assert ms.blocks_copied == copied
        assert cluster.probe_many(seqs) == [3 * B] * len(seqs)
    finally:
        close_all(cluster, servers)


def test_remove_node_drains_then_retires():
    servers, cluster = mem_cluster(3, replication=2, node_ids=[f"node-{i}" for i in range(3)])
    try:
        rng = np.random.default_rng(22)
        seqs = [seq(rng, 2) for _ in range(24)]
        for toks in seqs:
            cluster.put_batch(toks, blocks(rng, 2))
        cluster.remove_node("node-1")
        assert cluster.in_transition
        assert cluster.probe_many(seqs) == [2 * B] * len(seqs)
        rep = cluster.maintenance(0)
        assert rep["migration"]["done"] and not cluster.in_transition
        assert 1 in cluster.retired_nodes and 1 not in cluster.live_nodes
        assert cluster.probe_many(seqs) == [2 * B] * len(seqs)
        assert all(1 not in cluster.replicas_for(t) for t in seqs)
        assert cluster.scrape_cluster()["nodes"][1] == {"retired": True}
    finally:
        close_all(cluster, servers)


def test_death_triggers_repair_back_to_full_replication():
    servers, cluster = mem_cluster(3, replication=2, node_ids=[f"node-{i}" for i in range(3)])
    try:
        rng = np.random.default_rng(23)
        seqs = [seq(rng, 2) for _ in range(24)]
        for toks in seqs:
            cluster.put_batch(toks, blocks(rng, 2))
        victim = cluster.replicas_for(seqs[0])[0]
        servers[victim].close()
        assert cluster.probe_many(seqs) == [2 * B] * len(seqs)
        assert victim in cluster.down_nodes
        rep = cluster.maintenance(0)
        assert rep["migration"]["kind"] == "repair" and rep["migration"]["done"]
        ms = cluster.migrator.stats
        assert ms.repairs_completed == 1 and ms.repair_blocks > 0 and ms.repair_lag_s > 0
        for toks in seqs:
            assert sum(cluster.nodes[i].probe(toks) == 2 * B for i in cluster.live_nodes) >= 2
        assert cluster.maintenance(0)["migration"] == {"active": False}
        g = cluster.scrape_cluster()["cluster"]["gauges"]
        assert g["repro_migration_repairs_completed"] == 1.0 and g["repro_migration_repair_blocks"] > 0
    finally:
        close_all(cluster, servers)


@pytest.mark.timeout(180)
def test_sigkill_mid_migration_loses_no_committed_blocks(tmp_path):
    """On child-process port nodes: SIGKILL a migration's source between
    incremental steps; reads stay served, the rebalance completes from
    the survivors and repair restores R copies."""
    nodes = spawn_nodes(tmp_path, 4)
    cluster = ClusterKVBlockStore([n.address for n in nodes[:3]], replication=2, retries=0,
                                  connect_timeout_s=2.0, node_ids=[f"node-{i}" for i in range(3)])
    try:
        rng = np.random.default_rng(24)
        seqs = [seq(rng, 2) for _ in range(24)]
        payloads = [blocks(rng, 2) for _ in seqs]
        for toks, bs in zip(seqs, payloads):
            cluster.put_batch(toks, bs)
        cluster.add_node(nodes[3].address, node_id="node-3")
        step = cluster.migrate_step(max_pages=1)
        assert step["active"] or step["done"]
        assert cluster.probe_many(seqs) == [2 * B] * len(seqs)
        nodes[cluster.replicas_for(seqs[0])[0]].kill()
        assert cluster.probe_many(seqs) == [2 * B] * len(seqs)
        for _ in range(20):
            cluster.maintenance(0)
            ms = cluster.migrator.stats
            if not cluster.in_transition and not cluster.migrator.active and ms.repairs_completed >= 1:
                break
            assert cluster.probe_many(seqs) == [2 * B] * len(seqs)
        ms = cluster.migrator.stats
        assert not cluster.in_transition and ms.migrations_completed >= 1 and ms.repairs_completed >= 1
        got = cluster.get_many([(t, 2 * B) for t in seqs])
        assert all(all(np.array_equal(a, b) for a, b in zip(g, bs)) for g, bs in zip(got, payloads))
        for toks in seqs:
            assert sum(cluster.nodes[i].probe(toks) == 2 * B for i in cluster.live_nodes) >= 2
        g = cluster.scrape_cluster()["cluster"]["gauges"]
        assert g["repro_migration_migrations_completed"] >= 1.0 and g["repro_migration_repairs_completed"] >= 1.0
        assert g["repro_migration_blocks_pulled"] >= g["repro_migration_blocks_copied"] > 0
    finally:
        cluster.close()
        for n in nodes:
            n.close()
