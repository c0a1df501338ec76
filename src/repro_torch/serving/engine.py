"""Serving engine: continuous batching over the cache hierarchy.

Request lifecycle (paper Fig. 6):
  submit -> (batch formation) -> acquire (radix match + disk probe/get)
         -> prefill the non-reused suffix -> commit (write-through put)
         -> first token (TTFT recorded) -> release -> maintenance

Production concerns implemented here:
  * continuous batching with a token budget per engine step,
  * TTFT accounting split into the wait from ``submit`` until the engine
    thread starts serving the request (``queue_s``) + measured I/O +
    (modeled or real) compute,
  * a two-stage pipeline (``runtime=RuntimeServices(...)``): while batch k
    is being served, batch k+1's disk fetches (probe + batched get) are
    already running on the I/O executor — ``hierarchy.plan`` on the engine
    thread, ``hierarchy.fetch`` on the pool, ``hierarchy.fulfill`` back on
    the engine thread.  TTFT then pays only the *non-overlapped* remainder
    of the I/O (``io_wait``), not the full promotion,
  * write-behind commits: the disk write-through rides the runtime's
    ``CommitQueue`` drain thread instead of the request,
  * one fetch a request, waited for: the engine never hedges, so
    ``RequestRecord.hedged``, ``EngineStats.hedged_reads`` and
    ``redispatches``, kept from the reference's surface, read False / 0,
  * scheduled maintenance (LSM compaction / file merging) between batches —
    run through ``MaintenanceService`` off the request path when a runtime
    is attached, inline otherwise,
  * request timelines (``tracing=True``): per request the spans ``queue``,
    ``plan``, ``fetch`` (with the store's spans beneath it, on the I/O
    thread), ``io_wait``, ``fulfill``, ``compute`` (with the hook's) and
    ``commit``, kept in ``ServingEngine.traces`` by request id.

Concurrency contract for the stats: ``EngineStats`` is only ever mutated
on the engine thread.  Worker-side counters live in the runtime services'
own locked stats objects and are folded in via ``harvest()`` /
``runtime_report()`` on the engine thread, so totals stay consistent
without putting a lock on the request path.
"""

from __future__ import annotations

import time
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..cache.hierarchy import AcquirePlan, CacheHierarchy, DiskFetch
from ..obs import ENGINE_SPANS, MetricsRegistry, TraceContext, activate, dataclass_gauges
from ..obs.tracing import TraceSink, maybe_span
from ..runtime import RuntimeServices
from .compute_model import ComputeModel


@dataclass
class RequestRecord:
    rid: int
    prompt_len: int
    reused_tokens: int = 0
    io_s: float = 0.0
    io_wait_s: float = 0.0  # non-overlapped wait on the prefetch future
    first_block_s: Optional[float] = None  # streamed fetch: time-to-first-block
    compute_s: float = 0.0
    ttft_s: float = 0.0
    hedged: bool = False
    prefetched: bool = False
    stage: int = -1
    queue_s: float = 0.0  # submit -> the engine thread starts serving it

    @property
    def service_s(self) -> float:
        """TTFT less the queue: the I/O and compute spent on the request."""
        return self.io_s + self.compute_s


@dataclass
class EngineStats:
    completed: int = 0
    hedged_reads: int = 0
    redispatches: int = 0
    maintenance_runs: int = 0
    # aggregated from backend maintenance reports; a sharded backend sums
    # these across the shards each cycle touched
    maintenance_compactions: int = 0
    evicted_files: int = 0

    # pipeline accounting (engine-thread-only writers; see module docstring)
    prefetched_requests: int = 0
    prefetch_ready: int = 0  # future already resolved when the engine needed it
    io_wait_s: float = 0.0  # I/O the pipeline could NOT hide (charged to TTFT)
    overlap_io_s: float = 0.0  # I/O executed under the previous batch's service

    ttfts: List[float] = field(default_factory=list)
    ttfbs: List[float] = field(default_factory=list)  # streamed fetches only
    hits: List[float] = field(default_factory=list)

    @property
    def mean_ttft(self) -> float:
        return float(np.mean(self.ttfts)) if self.ttfts else 0.0

    @property
    def mean_ttfb(self) -> float:
        """Mean time-to-first-block across fetches that streamed — the
        latency at which the pipeline starts installing disk state."""
        return float(np.mean(self.ttfbs)) if self.ttfbs else 0.0

    @property
    def mean_hit(self) -> float:
        return float(np.mean(self.hits)) if self.hits else 0.0


@dataclass
class _Staged:
    """A request whose acquire phases 1(+2) already ran (``plan`` is None
    in the no-runtime path, where acquire plans internally)."""

    req: object
    plan: Optional[AcquirePlan]
    future: Optional[object] = None  # Future[DiskFetch] when prefetched
    trace: Optional[TraceContext] = None  # per-request trace (tracing=True)
    arrival: float = 0.0  # perf_counter at submit


class ServingEngine:
    def __init__(
        self,
        hierarchy: CacheHierarchy,
        compute: ComputeModel,
        kv_bytes_per_token: int,
        max_batch_tokens: int = 16_384,
        maintenance_every: int = 8,
        real_prefill: Optional[Callable] = None,
        runtime: Optional[RuntimeServices] = None,
        pipeline: Optional[bool] = None,
        simulate_compute_wall: bool = False,
        registry: Optional[MetricsRegistry] = None,
        tracing: bool = False,
    ):
        """``simulate_compute_wall``: when compute is *modeled* (no
        ``real_prefill``), additionally occupy real wall-clock time for the
        modeled duration (a GIL-releasing sleep — the engine thread is
        "waiting on the accelerator").  This is what makes overlap
        measurable end to end on a CPU-only container: the I/O executor
        prefetches into exactly the window a GPU deployment would expose.
        Off by default (tests and hit-rate benchmarks don't want the wall
        time).

        ``tracing``: a ``TraceContext`` per request; the finished traces of
        the last ``TRACE_SINK_CAPACITY`` requests are kept in
        ``self.traces`` (a ``TraceSink``, by request id)."""
        self.h = hierarchy
        self.compute = compute
        self.kv_bytes_per_token = kv_bytes_per_token
        self.max_batch_tokens = max_batch_tokens
        self.maintenance_every = maintenance_every
        self.real_prefill = real_prefill  # (tokens, reused) -> (blocks, seconds)
        self.simulate_compute_wall = simulate_compute_wall
        self.runtime = runtime
        # pipeline defaults to on exactly when an async runtime is attached
        self.pipeline = bool(runtime and runtime.async_mode) if pipeline is None else bool(pipeline)
        if runtime is not None:
            # wire the write-behind queue into the hierarchy (unless the
            # caller attached their own) and bind off-path maintenance
            if self.h.commit_queue is None and runtime.commits is not None:
                self.h.commit_queue = runtime.commits
            self._maintenance = runtime.bind_maintenance(self.h.maintenance)
        else:
            self._maintenance = None
        self.stats = EngineStats()
        self._queue: Deque = deque()  # (request, arrival); popleft is O(1)
        self._staged: Optional[List[_Staged]] = None  # batch k+1, prefetching
        self._batches = 0
        self._block_template: Optional[np.ndarray] = None
        self.tracing = bool(tracing)
        self.traces = TraceSink()
        self.registry = registry if registry is not None else MetricsRegistry()
        self._register_metrics()

    def _register_metrics(self) -> None:
        """Wire the engine, cache, and runtime stats into the registry so
        one snapshot covers the whole serving stack.  Collectors read the
        live dataclasses at snapshot time — no double bookkeeping."""
        reg = self.registry
        self._h_ttft = reg.histogram("repro_engine_ttft_seconds")
        self._h_io_wait = reg.histogram("repro_engine_io_wait_seconds")
        reg.register_collector(dataclass_gauges(
            "repro_engine", self.stats,
            extra=lambda: {
                "repro_engine_mean_ttft_s": self.stats.mean_ttft,
                "repro_engine_mean_ttfb_s": self.stats.mean_ttfb,
                "repro_engine_mean_hit": self.stats.mean_hit,
                "repro_engine_streamed_fetches": float(len(self.stats.ttfbs)),
            }))
        reg.register_collector(dataclass_gauges("repro_cache", self.h.stats))
        if self.runtime is not None:
            reg.register_collector(dataclass_gauges(
                "repro_executor", self.runtime.executor.stats,
                lock=self.runtime.executor._lock))
            if self.runtime.commits is not None:
                reg.register_collector(dataclass_gauges(
                    "repro_commit_queue", self.runtime.commits.stats))
        if self._maintenance is not None:
            reg.register_collector(dataclass_gauges(
                "repro_maintenance", self._maintenance.stats))

    # ------------------------------------------------------------ lifecycle
    def submit(self, request) -> None:
        self._queue.append((request, time.perf_counter()))

    def run(self) -> List[RequestRecord]:
        out = []
        while self._queue or self._staged:
            out.extend(self.step())
        return out

    def drain(self) -> None:
        """Quiesce the runtime (flush write-behind, finish maintenance) and
        fold its counters into the engine stats."""
        if self.runtime is not None:
            self.runtime.drain()
            self._harvest_maintenance()

    def close(self) -> None:
        if self.runtime is not None:
            self.drain()
            self.runtime.close()

    # ------------------------------------------------------- batch formation
    def _form_batch(self) -> List:
        batch, tokens = [], 0
        while self._queue and tokens + len(self._queue[0][0].tokens) <= self.max_batch_tokens:
            item = self._queue.popleft()
            batch.append(item)
            tokens += len(item[0].tokens)
        if not batch and self._queue:  # oversized single request
            batch.append(self._queue.popleft())
        return batch

    def _stage(self, batch: List, prefetch: bool) -> List[_Staged]:
        """Phase 1 for every request (engine thread); optionally launch
        phase 2 on the executor (prefetch-ahead)."""
        staged = []
        ex = self.runtime.executor if self.runtime is not None else None
        for r, arrival in batch:
            trace = TraceContext() if self.tracing else None
            if ex is None:
                # no runtime: the legacy acquire path re-plans internally,
                # so planning here would walk the radix tree twice
                staged.append(_Staged(req=r, plan=None, trace=trace, arrival=arrival))
                continue
            with activate(trace) if trace is not None else nullcontext():
                plan = self.h.plan(r.tokens)
                fut = None
                # never stall the engine thread on the admission gate: if
                # the pool is saturated, try_submit declines and the fetch
                # runs at serve time in _resolve_fetch, when slots have
                # freed.  (The old in_flight < max_pending check raced
                # other submitters into exactly the stall it was written
                # to avoid.)  try_submit captures the active trace, so the
                # prefetch worker's spans land on this request.
                if prefetch and plan.need_disk:
                    fut = ex.try_submit(self.h.fetch, plan)
                    if fut is not None:
                        self.stats.prefetched_requests += 1
            staged.append(_Staged(req=r, plan=plan, future=fut, trace=trace, arrival=arrival))
        return staged

    def step(self) -> List[RequestRecord]:
        """One continuous-batching iteration.  Serial mode: take a batch,
        serve it, run maintenance.  Pipelined mode: serve the batch whose
        fetches were launched last step, while this step launches the
        fetches of the next one."""
        can_prefetch = self.pipeline and self.runtime is not None and self.runtime.async_mode
        if self._staged is not None:
            current = self._staged
            self._staged = None
        else:
            # first batch of a burst: no earlier step staged it, but its
            # fetches still fan out on the executor (intra-batch overlap) —
            # and they must be submitted BEFORE the next batch's prefetch
            # so the FIFO pool serves the batch we are about to block on
            current = self._stage(self._form_batch(), prefetch=can_prefetch)
        if can_prefetch:
            nxt = self._stage(self._form_batch(), prefetch=True)
            self._staged = nxt or None
        records = [self._serve_one(s) for s in current]
        self._batches += 1
        if self._batches % self.maintenance_every == 0:
            if self._maintenance is not None and self.runtime.async_mode:
                self._maintenance.maybe_schedule()
                self.stats.maintenance_runs += 1
            else:
                rep = self._maintenance.run_inline() if self._maintenance else self.h.maintenance()
                self.stats.maintenance_runs += 1
                if self._maintenance is None:
                    self.stats.maintenance_compactions += int(rep.get("compactions", 0) or 0)
                    self.stats.evicted_files += int(rep.get("evicted_files", 0) or 0)
        self._harvest_maintenance()
        return records

    def _harvest_maintenance(self) -> None:
        if self._maintenance is None:
            return
        got = self._maintenance.harvest()
        self.stats.maintenance_compactions += got.compactions
        self.stats.evicted_files += got.evicted_files

    # ------------------------------------------------------------- serving
    def _resolve_fetch(self, st: _Staged) -> Tuple[DiskFetch, float]:
        """Obtain the DiskFetch for a staged request: wait on the prefetch
        future or, if none was launched, run the fetch through the executor
        now and wait on it.  Returns (fetch, wait_seconds)."""
        fut = st.future
        if fut is None:
            if not st.plan.need_disk:
                return DiskFetch(), 0.0
            fut = self.runtime.executor.submit(self.h.fetch, st.plan)
        elif fut.done():
            self.stats.prefetch_ready += 1
        t0 = time.perf_counter()
        fetched = fut.result()
        return fetched, time.perf_counter() - t0

    def _serve_one(self, st: _Staged) -> RequestRecord:
        queue_s = time.perf_counter() - st.arrival
        with activate(st.trace) if st.trace is not None else nullcontext():
            if st.trace is not None:
                st.trace.add_span("queue", st.arrival, queue_s)
            rec = self._serve(st, queue_s)
        self._h_ttft.observe(rec.ttft_s)
        self._h_io_wait.observe(rec.io_wait_s)
        if st.trace is not None:
            # one histogram per pipeline span: the engine-side closure of
            # the trace, matching the node-side close-out in the server;
            # the whole trace stays in the sink
            totals = st.trace.span_totals()
            for name in ENGINE_SPANS:
                if name in totals:
                    self.registry.histogram(
                        f"repro_engine_span_seconds_{name}").observe(totals[name])
            self.traces.add(rec.rid, st.trace)
        return rec

    def _serve(self, st: _Staged, queue_s: float = 0.0) -> RequestRecord:
        req = st.req
        tokens = req.tokens
        B = self.h.block_size
        prefetched = st.future is not None
        first_block_s: Optional[float] = None
        if self.runtime is not None:
            with maybe_span("io_wait"):
                fetched, wait_s = self._resolve_fetch(st)
            first_block_s = fetched.first_block_s
            t1 = time.perf_counter()
            acq = self.h.fulfill(st.plan, fetched)
            install_s = time.perf_counter() - t1
            # TTFT charges only the I/O the pipeline failed to hide: the
            # blocking wait plus the on-thread install.  Whatever the fetch
            # did while the previous batch was being served is overlap.
            io_s = wait_s + install_s
            self.stats.io_wait_s += wait_s
            if prefetched:
                self.stats.overlap_io_s += max(0.0, fetched.io_s - wait_s)
        else:
            t0 = time.perf_counter()
            acq = self.h.acquire(tokens)
            io_s = wait_s = time.perf_counter() - t0
        reused = acq.reuse_tokens
        n_new = len(tokens) - reused

        with maybe_span("compute"):
            if self.real_prefill is not None:
                new_blocks, compute_s = self.real_prefill(tokens, reused)
            else:
                compute_s = self.compute.prefill_s(n_new, context=reused)
                n_blocks = (len(tokens) // B) - (reused // B)
                # realistic payload entropy (zeros would compress to nothing
                # and fake the storage pressure the paper's claims rest on)
                if self._block_template is None:
                    shape = (B, max(1, self.kv_bytes_per_token // 2))
                    self._block_template = np.random.default_rng(0).standard_normal(shape).astype(np.float16)
                new_blocks = [self._block_template] * n_blocks
                if self.simulate_compute_wall and compute_s > 0:
                    time.sleep(compute_s)  # GIL released: prefetch runs under this
        with maybe_span("commit"):
            self.h.commit(tokens, new_blocks, acq)
            self.h.release(acq)

        rec = RequestRecord(
            rid=getattr(req, "rid", -1),
            prompt_len=len(tokens),
            reused_tokens=reused,
            io_s=io_s,
            io_wait_s=wait_s,
            first_block_s=first_block_s,
            compute_s=compute_s,
            ttft_s=queue_s + io_s + compute_s,
            prefetched=prefetched,
            stage=getattr(req, "stage", -1),
            queue_s=queue_s,
        )
        self.stats.completed += 1
        self.stats.ttfts.append(rec.ttft_s)
        if first_block_s is not None:
            self.stats.ttfbs.append(first_block_s)
        self.stats.hits.append(reused / max(1, len(tokens)))
        return rec

    # ---------------------------------------------------------------- report
    def metrics_snapshot(self) -> Dict:
        """Full registry snapshot (counters / gauges / histograms) — the
        engine-side twin of the node server's ``OP_METRICS`` reply."""
        return self.registry.snapshot()

    def runtime_report(self) -> Dict:
        """Engine + runtime counters in one machine-readable dict (the
        benchmark artifact format).  Scalar fields are read back out of
        the metrics registry — the same snapshot the scrape endpoint
        exports — so the report and the exposition can never disagree."""
        snap = self.registry.snapshot()
        g = snap["gauges"]
        ttft = snap["histograms"]["repro_engine_ttft_seconds"]
        out: Dict = {
            "completed": int(g.get("repro_engine_completed", 0)),
            "mean_ttft_s": g.get("repro_engine_mean_ttft_s", 0.0),
            "mean_time_to_first_block_s": g.get("repro_engine_mean_ttfb_s", 0.0),
            "streamed_fetches": int(g.get("repro_engine_streamed_fetches", 0)),
            "mean_hit": g.get("repro_engine_mean_hit", 0.0),
            "hedged_reads": int(g.get("repro_engine_hedged_reads", 0)),
            "prefetched_requests": int(g.get("repro_engine_prefetched_requests", 0)),
            "prefetch_ready": int(g.get("repro_engine_prefetch_ready", 0)),
            "io_wait_s": g.get("repro_engine_io_wait_s", 0.0),
            "overlap_io_s": g.get("repro_engine_overlap_io_s", 0.0),
            "maintenance_runs": int(g.get("repro_engine_maintenance_runs", 0)),
            "maintenance_compactions": int(g.get("repro_engine_maintenance_compactions", 0)),
            "evicted_files": int(g.get("repro_engine_evicted_files", 0)),
            "plan_stale": int(g.get("repro_cache_plan_stale", 0)),
            "writeback_blocks": int(g.get("repro_cache_writeback_blocks", 0)),
            "ttft_p50_s": ttft["p50"],
            "ttft_p95_s": ttft["p95"],
            "ttft_p99_s": ttft["p99"],
        }
        if self.runtime is not None:
            out["runtime"] = self.runtime.report()
        return out
