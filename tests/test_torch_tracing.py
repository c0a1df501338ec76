"""The port's request timeline on the CPU: requests served through
``ServingEngine`` over a 4-shard ``ShardedKVBlockStore``, two I/O threads
and the real-prefill hook on a smoke config, some of them reusing a prefix
the warm-up left on disk.  With tracing on, every request's trace holds
its spans on the right threads under the right parents, each inside its
parent; with it off nothing is recorded and the cache does the same."""

import threading
import time
from dataclasses import dataclass
from typing import List

import pytest

from repro_torch.cache.hierarchy import CacheHierarchy
from repro_torch.configs import get_config
from repro_torch.core.sharded_store import ShardedKVBlockStore
from repro_torch.models import api
from repro_torch.obs.tracing import (TRACE_SINK_CAPACITY, TraceContext, TraceSink, activate, current_trace,
                                     maybe_span)
from repro_torch.runtime import RuntimeServices
from repro_torch.runtime.executor import IOExecutor
from repro_torch.serving.compute_model import ComputeModel
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.real_prefill import make_real_prefill

BLOCK = 16
DOC = 5 * BLOCK  # a document: 5 blocks
PROMPT = DOC + BLOCK  # the document and one fresh block
DOCS = 3
REQUESTS = 8


@dataclass
class Req:
    rid: int
    tokens: List[int]


def doc(d: int) -> List[int]:
    return [(97 * d + 7 * i) % 250 + 1 for i in range(DOC)]


def prompt(rid: int) -> List[int]:
    return doc(rid % DOCS) + [(13 * rid + i) % 250 + 1 for i in range(BLOCK)]


@pytest.fixture(scope="module")
def hook():
    cfg = get_config("glm4-9b", smoke=True)
    params = api.init_params(cfg, 0, "cpu")
    return cfg, make_real_prefill(cfg, params, BLOCK, "cpu", lengths=(PROMPT,))


def serve(root, hook, tracing: bool):
    """Warm up every document (drained to disk), then serve REQUESTS
    requests one a step, pipelined; the blocks each fetch's ``get_batch``
    returned, by trace id."""
    cfg, fn = hook
    runtime = RuntimeServices(io_threads=2)
    store = ShardedKVBlockStore(str(root), n_shards=4, block_size=BLOCK, io_executor=runtime.executor)
    got = {}
    get_batch = store.get_batch

    def counted(tokens, n_tokens, start_block=0):
        out = get_batch(tokens, n_tokens, start_block=start_block)
        tr = current_trace()
        if tr is not None:
            got[tr.trace_id] = got.get(tr.trace_id, 0) + len(out)
        return out

    store.get_batch = counted
    h = CacheHierarchy(BLOCK, device_budget_blocks=12, host_budget_blocks=4, store=store)
    kv = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.d_head * 2
    eng = ServingEngine(h, ComputeModel(cfg), kv_bytes_per_token=kv, max_batch_tokens=PROMPT, real_prefill=fn,
                        runtime=runtime, tracing=tracing)
    try:
        for d in range(DOCS):
            eng.submit(Req(1000 + d, doc(d) + [251] * BLOCK))
        eng.run()
        eng.drain()
        eng.traces.clear()
        before = {k: getattr(h.stats, k) for k in ("tokens_hit_device", "tokens_hit_host", "tokens_hit_disk")}
        for rid in range(REQUESTS):
            eng.submit(Req(rid, prompt(rid)))
        recs = eng.run()
        hits = {k: getattr(h.stats, k) - v for k, v in before.items()}
        eng.close()
    finally:
        store.close()
    return eng, recs, hits, got


@pytest.fixture(scope="module")
def runs(hook, tmp_path_factory):
    return {t: serve(tmp_path_factory.mktemp(f"traced{int(t)}"), hook, t) for t in (True, False)}


def by_name(trace, name):
    return [s for s in trace.records if s.name == name]


def test_engine_thread_spans_and_the_hooks_under_compute(runs):
    eng, recs, _, _ = runs[True]
    main = threading.get_ident()
    assert [r.rid for r in recs] == list(range(REQUESTS))
    for r in recs:
        tr = eng.traces.get(r.rid)
        assert tr is not None, r.rid
        for name in ("queue", "io_wait", "fulfill", "compute", "commit"):
            (sp,) = by_name(tr, name)
            assert sp.thread == main, (r.rid, sp)
        (compute,) = by_name(tr, "compute")
        for name in ("prefill.replay", "prefill.copy_out"):
            (sp,) = by_name(tr, name)
            assert sp.parent == compute.sid and sp.thread == main
        assert by_name(tr, "prefill.copy_out")[0].units == (PROMPT - r.reused_tokens) // BLOCK
        assert by_name(tr, "queue")[0].wall_s == pytest.approx(r.queue_s, abs=1e-6)


def test_fetch_and_the_store_spans_run_on_an_io_thread_under_fetch(runs):
    """Every request's fetch probes and reads on an I/O thread, its store
    spans under it; the fetch skips the blocks the device held at plan
    time.  A block spilled after the plan is read late, under ``fulfill``
    on the engine thread."""
    eng, recs, hits, _ = runs[True]
    main = threading.get_ident()
    assert hits["tokens_hit_disk"] > 0  # some prefixes came back from disk
    assert eng.h.stats.fetch_skipped_blocks > 0
    for r in recs:
        tr = eng.traces.get(r.rid)
        fetches = {s.sid: s for s in by_name(tr, "fetch")}
        (fulfill,) = by_name(tr, "fulfill")
        assert fetches and all(f.thread != main and f.thread_name.startswith("repro-io") for f in fetches.values())
        for name in ("store.probe", "store.scan", "store.read", "store.decode"):
            spans = by_name(tr, name)
            assert any(sp.parent in fetches for sp in spans), (r.rid, name)
            for sp in spans:
                if sp.parent == fulfill.sid:
                    assert name != "store.probe" and sp.thread == main, (r.rid, sp)
                else:
                    assert sp.parent in fetches and sp.thread == fetches[sp.parent].thread, (r.rid, sp)
        assert all(sp.units and sp.units > 0 for sp in by_name(tr, "store.read") + by_name(tr, "store.decode"))


def test_every_span_lies_inside_its_parent_and_spends_no_more_cpu_than_wall(runs):
    eng, recs, _, _ = runs[True]
    for r in recs:
        spans = {s.sid: s for s in eng.traces.get(r.rid).records}
        for sp in spans.values():
            assert sp.end >= sp.start
            if sp.cpu_s is not None:
                assert 0.0 <= sp.cpu_s <= sp.wall_s, sp
            if sp.parent is not None:
                p = spans[sp.parent]
                assert p.start <= sp.start and sp.end <= p.end, (p, sp)


def test_decode_counts_sum_to_the_blocks_get_batch_returned(runs):
    eng, recs, _, got = runs[True]
    for r in recs:
        tr = eng.traces.get(r.rid)
        assert sum(s.units for s in by_name(tr, "store.decode")) == got[tr.trace_id] > 0


@pytest.mark.parametrize("tracing", [True, False])
def test_ttft_is_queue_plus_io_plus_compute(runs, tracing):
    _, recs, _, _ = runs[tracing]
    for r in recs:
        assert r.queue_s >= 0.0
        assert r.ttft_s == r.queue_s + r.io_s + r.compute_s
        assert r.service_s == pytest.approx(r.ttft_s - r.queue_s, rel=1e-12, abs=1e-15)


SLEEP = 0.5  # the straggling get's stall, seconds


def serve_straggler(root, hook, runtime: bool, tracing: bool):
    """Warm up every document (drained to disk), serve requests on
    documents 1 and 2 until document 0 has left the device and host tiers,
    then serve one request on document 0 alone, its first ``get_batch``
    stalled SLEEP seconds.  The engine, the straggler's record, the
    ``get_batch`` calls made while it was served, the disk tokens it hit
    and the clock at the end of the stalled get."""
    cfg, fn = hook
    rt = RuntimeServices(io_threads=2) if runtime else None
    store = ShardedKVBlockStore(str(root), n_shards=4, block_size=BLOCK, io_executor=rt.executor if rt else None)
    get_batch = store.get_batch
    calls, stall = [], {"armed": False, "end": None}

    def straggling(tokens, n_tokens, start_block=0):
        calls.append(threading.get_ident())
        armed, stall["armed"] = stall["armed"], False
        if armed:
            time.sleep(SLEEP)
        out = get_batch(tokens, n_tokens, start_block=start_block)
        if armed:
            stall["end"] = time.perf_counter()
        return out

    store.get_batch = straggling
    h = CacheHierarchy(BLOCK, device_budget_blocks=12, host_budget_blocks=4, store=store)
    eng = ServingEngine(h, ComputeModel(cfg), kv_bytes_per_token=cfg.kv_bytes_per_token, max_batch_tokens=PROMPT,
                        real_prefill=fn, runtime=rt, tracing=tracing)
    try:
        for d in range(DOCS):
            eng.submit(Req(1000 + d, doc(d) + [251] * BLOCK))
        eng.run()
        eng.drain()
        for rid in range(1, 3 * DOCS):
            if rid % DOCS:
                eng.submit(Req(rid, prompt(rid)))
        eng.run()
        before, n0 = h.stats.tokens_hit_disk, len(calls)
        stall["armed"] = True
        eng.submit(Req(0, prompt(0)))
        (rec,) = eng.run()
        disk = h.stats.tokens_hit_disk - before
        eng.close()
    finally:
        store.close()
    return eng, rec, calls[n0:], disk, stall["end"]


@pytest.mark.parametrize("tracing", [True, False], ids=["traced", "untraced"])
@pytest.mark.parametrize("runtime", [True, False], ids=["runtime", "inline"])
def test_a_straggling_fetch_is_fetched_once_and_waited_for(hook, tmp_path, runtime, tracing):
    """A fetch that stalls after fast ones is not hedged: the store is read
    once for the request, the engine waits for that read, and, traced, the
    request's trace holds one ``fetch`` with every span inside its
    parent."""
    eng, rec, reads, disk, stall_end = serve_straggler(tmp_path, hook, runtime, tracing)
    assert disk > 0 and stall_end is not None  # the straggler reused a prefix from disk, through the stalled get
    assert len(reads) == 1
    assert not rec.hedged and eng.stats.hedged_reads == eng.stats.redispatches == 0
    assert eng.runtime_report()["hedged_reads"] == 0
    # served alone, the engine starts waiting as the fetch starts
    assert rec.io_wait_s >= SLEEP / 2
    if tracing:
        spans = {s.sid: s for s in eng.traces.get(rec.rid).records}
        (fetch,) = [s for s in spans.values() if s.name == "fetch"]
        assert fetch.end >= stall_end
        for sp in spans.values():
            if sp.parent is not None:
                p = spans[sp.parent]
                assert p.start <= sp.start and sp.end <= p.end, (p, sp)
        if runtime:
            (io_wait,) = [s for s in spans.values() if s.name == "io_wait"]
            assert io_wait.end >= stall_end
    else:
        assert len(eng.traces) == 0


def test_tracing_off_records_nothing_and_reuses_as_the_traced_run(runs):
    eng_on, recs_on, hits_on, _ = runs[True]
    eng_off, recs_off, hits_off, got_off = runs[False]
    assert len(eng_off.traces) == 0 and not got_off
    assert not any(k.startswith("repro_engine_span_seconds_") for k in eng_off.metrics_snapshot()["histograms"])
    assert [r.reused_tokens for r in recs_off] == [r.reused_tokens for r in recs_on]
    assert hits_off == hits_on
    assert len(eng_on.traces) == REQUESTS


def test_pipeline_spans_keep_their_histograms(runs):
    eng, _, _, _ = runs[True]
    hist = eng.metrics_snapshot()["histograms"]
    for name in ("plan", "fetch", "fulfill", "compute", "commit"):
        assert hist[f"repro_engine_span_seconds_{name}"]["count"] == DOCS + REQUESTS, name
    assert not any(k.startswith("repro_engine_span_seconds_store") for k in hist)


def test_worker_spans_take_the_span_that_handed_the_work_over_as_parent():
    ex = IOExecutor(max_workers=1)
    tr = TraceContext()
    try:
        with activate(tr):
            with maybe_span("outer") as outer:
                ex.submit(_spanned, "worker").result()
            ex.submit(_spanned, "root").result()
    finally:
        ex.close()
    spans = {s.name: s for s in tr.records}
    assert spans["worker"].parent == outer.sid and spans["worker"].thread != threading.get_ident()
    assert spans["root"].parent is None
    assert current_trace() is None


def _spanned(name):
    with maybe_span(name, units=3) as sp:
        time.sleep(0.001)
    return sp


def test_span_records_units_thread_time_and_nesting():
    tr = TraceContext()
    with activate(tr):
        assert current_trace() is tr
        with maybe_span("a") as a:
            assert current_trace() is not tr and current_trace().trace_id == tr.trace_id
            with maybe_span("b", units=2) as b:
                sum(range(10000))
            a.units = 5
    assert (a.parent, b.parent, a.units, b.units) == (None, a.sid, 5, 2)
    assert 0.0 <= b.cpu_s <= b.wall_s and a.start <= b.start <= b.end <= a.end
    assert [n for n, _, _ in tr.spans] == ["b", "a"] and set(tr.span_totals()) == {"a", "b"}
    with maybe_span("off") as off:
        assert off is None


def test_sink_keeps_the_last_capacity_traces():
    sink = TraceSink()
    n = TRACE_SINK_CAPACITY
    traces = {rid: TraceContext() for rid in range(n + 2)}
    for rid, tr in traces.items():
        sink.add(rid, tr)
    assert len(sink) == n and sink.get(1) is None and sink.get(n + 1) is traces[n + 1]
    assert sink.take([0, 1, 2, n + 1, n + 9]) == {2: traces[2], n + 1: traces[n + 1]}
    sink.clear()
    assert len(sink) == 0
