"""The port's serve path over its cache cluster, at smoke size on the CPU:
``launch.serve_e2e.main`` with a ``ClusterKVBlockStore`` over 3 in-process
port nodes at R 2 hits what the 4-shard store's run hits, stage by stage,
and every block the hook handed over reads back from the cluster bit for
bit, also with one node closed.  And ``examples/failover_torch.py`` runs to
its end."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.cluster import CacheNodeServer, ClusterKVBlockStore
from repro_torch.core.baselines import MemoryOnlyStore
from repro_torch.launch import serve_e2e

ROOT = Path(__file__).resolve().parents[1]


class Tap:
    """Wraps the serve hook and keeps a copy of what it hands over."""

    def __init__(self, hook):
        self.hook, self.outputs = hook, []

    def __call__(self, tokens, reused):
        blocks, seconds = self.hook(tokens, reused)
        self.outputs.append((list(tokens), reused, [b.copy() for b in blocks]))
        return blocks, seconds


@pytest.fixture(scope="module")
def served():
    servers = [CacheNodeServer(MemoryOnlyStore(1 << 30, block_size=serve_e2e.BLOCK), io_threads=2).start()
               for _ in range(3)]
    cluster = ClusterKVBlockStore([s.address for s in servers], replication=2, retries=0, io_threads=2,
                                  node_ids=[f"node-{i}" for i in range(3)])
    taps = []
    try:
        res = serve_e2e.main(smoke=True, device="cpu", store=cluster, verbose=False,
                             tap=lambda hook: taps.append(Tap(hook)) or taps[-1])
        yield res, taps[0], cluster, servers
    finally:
        cluster.close()
        for s in servers:
            s.close()


def _read_back(cluster, outputs):
    """Every block each hook call handed over, read from the cluster with
    get_many: True where it is the same bytes."""
    got = cluster.get_many([(toks, len(toks)) for toks, _, _ in outputs])
    ok = []
    for (toks, reused, want), have in zip(outputs, got):
        have = have[reused // serve_e2e.BLOCK:]
        ok.append(len(have) == len(want) and all(h.dtype == w.dtype and h.tobytes() == w.tobytes()
                                                 for h, w in zip(have, want)))
    return ok


def test_hits_over_the_cluster_equal_the_sharded_stores(served):
    res = served[0]
    sharded = serve_e2e.main(smoke=True, device="cpu", verbose=False)
    assert [s["hit"] for s in res["stages"]] == [s["hit"] for s in sharded["stages"]] == [0.0, 0.5, 0.75]
    assert res["requests"] == sharded["requests"]
    assert res["prefills"] == sharded["prefills"] and res["decoded"] == sharded["decoded"]


def test_every_committed_block_reads_back_bit_for_bit(served):
    res, tap, cluster, _ = served
    assert len(tap.outputs) == res["prefills"] - 1  # the decode's own prefill is not the hook's
    warm = tap.outputs[:len(res["corpus"])]
    assert sorted(t for t, _, _ in warm) == sorted(res["corpus"]) and all(r == 0 for _, r, _ in warm)
    assert all(_read_back(cluster, tap.outputs))
    assert cluster.stats.put_blocks == 2 * sum(len(b) for _, _, b in tap.outputs)  # R 2, raw


def test_every_block_reads_back_with_one_node_closed(served):
    """Runs after the two above (module order): the victim is the first
    replica of the first corpus prompt."""
    res, tap, cluster, servers = served
    committed = [cluster.probe(t) for t, _, _ in tap.outputs]
    victim = cluster.replicas_for(res["corpus"][0])[0]
    servers[victim].close()
    assert [cluster.probe(t) for t, _, _ in tap.outputs] == committed
    assert all(_read_back(cluster, tap.outputs))
    assert cluster.down_nodes == [victim]


def test_the_failover_example_runs_to_its_end():
    out = subprocess.run([sys.executable, str(ROOT / "examples" / "failover_torch.py")], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "ok — zero committed blocks lost across kill and rejoin" in out.stdout
    assert "[phase 2] lost committed blocks after kill: 0" in out.stdout
