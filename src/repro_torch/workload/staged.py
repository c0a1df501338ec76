"""Request generators for every serving benchmark: the paper's staged
hit-rate workload (§4.1) plus the multi-tenant variant.

``StagedWorkload`` progresses through stages with expected hit rates
[0.2 0.3 0.5 0.7 0.5 0.3 0.1 0.3 0.5 0.7]; each stage issues
``requests_per_stage`` requests of ``prompt_len`` tokens.  The expected hit
rate is the ratio of shared prompt tokens to total prompt tokens: a request
reuses the first ``hit_rate * prompt_len`` tokens of a previously issued
prompt (drawn from a warm corpus) and fills the tail with fresh tokens.

A warmup phase (paper: 100M tokens of KV cache, write-through) populates
both the memory tiers and the disk backend before measurement; the corpus
of warmup prefixes is what later stages share against.

``MultiTenantWorkload`` runs M independent staged corpora, each prompt
tagged with a tenant-id block so tenants never share prefixes — the
workload that exercises shard/node placement (distinct corpora spread
across shards of ``ShardedKVBlockStore`` or nodes of a cache cluster,
while each tenant's extensions stay local to its shard/node).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

PAPER_STAGES = (0.2, 0.3, 0.5, 0.7, 0.5, 0.3, 0.1, 0.3, 0.5, 0.7)


@dataclass
class Request:
    rid: int
    stage: int
    tokens: List[int]
    expected_hit: float


@dataclass
class StagedWorkload:
    prompt_len: int = 4096
    requests_per_stage: int = 1000
    stages: Sequence[float] = PAPER_STAGES
    vocab: int = 50_000
    block_size: int = 16
    corpus_size: int = 512  # distinct shared-prefix roots
    seed: int = 0

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)
        # corpus roots: long random token runs requests share prefixes of
        self.corpus = [
            self.rng.integers(0, self.vocab, size=self.prompt_len).tolist()
            for _ in range(self.corpus_size)
        ]
        self._rid = 0

    # ------------------------------------------------------------- warmup
    def warmup_prompts(self, total_tokens: int) -> Iterator[List[int]]:
        """Prompts covering the corpus until ~total_tokens have been issued
        (the paper's 100M-token write-through warmup, scaled by callers)."""
        issued = 0
        i = 0
        while issued < total_tokens:
            p = self.corpus[i % len(self.corpus)]
            yield list(p)
            issued += len(p)
            i += 1

    # ------------------------------------------------------------ requests
    def _make_request(self, stage_idx: int, hit: float) -> Request:
        shared = int(round(hit * self.prompt_len))
        # share a block-aligned prefix so cache-block granularity can hit it
        shared = (shared // self.block_size) * self.block_size
        root = self.corpus[int(self.rng.integers(0, len(self.corpus)))]
        fresh = self.rng.integers(0, self.vocab, size=self.prompt_len - shared)
        toks = list(root[:shared]) + fresh.tolist()
        self._rid += 1
        return Request(self._rid, stage_idx, toks, hit)

    def requests(self) -> Iterator[Request]:
        for si, hit in enumerate(self.stages):
            for _ in range(self.requests_per_stage):
                yield self._make_request(si, hit)

    def stage_requests(self, stage_idx: int) -> List[Request]:
        return [self._make_request(stage_idx, self.stages[stage_idx]) for _ in range(self.requests_per_stage)]


@dataclass
class MultiTenantWorkload:
    """M independent tenants, each with its own prefix corpus, interleaved
    round-robin — the traffic shape storage sharding exists for: M disjoint
    prefix keyspaces that a monolithic store serializes behind one memtable
    and WAL, but a ``ShardedKVBlockStore`` spreads across shards.

    Every prompt of tenant ``t`` starts with a tenant-tag block
    (``block_size`` copies of a token unique to ``t``, drawn from above the
    vocab range), so tenants never share a first block: hash routing keeps
    each tenant's whole prefix tree shard-local while distributing tenants
    across shards.  ``prompt_len`` includes the tag block."""

    n_tenants: int = 4
    prompt_len: int = 4096
    requests_per_stage: int = 1000  # total per stage, round-robin over tenants
    stages: Sequence[float] = PAPER_STAGES
    vocab: int = 50_000
    block_size: int = 16
    corpus_size: int = 128  # distinct shared-prefix roots per tenant
    seed: int = 0

    def __post_init__(self):
        body = self.prompt_len - self.block_size
        if body <= 0:
            raise ValueError("prompt_len must exceed block_size (tag block)")
        self.tenants = [
            StagedWorkload(
                prompt_len=body,
                requests_per_stage=self.requests_per_stage,
                stages=self.stages,
                vocab=self.vocab,
                block_size=self.block_size,
                corpus_size=self.corpus_size,
                seed=self.seed + 7919 * (t + 1),
            )
            for t in range(self.n_tenants)
        ]
        self._rid = 0

    def tag_block(self, tenant: int) -> List[int]:
        return [self.vocab + tenant] * self.block_size

    def _wrap(self, tenant: int, req: Request) -> Request:
        self._rid += 1
        toks = self.tag_block(tenant) + req.tokens
        # the tag block always hits after warmup; fold it into the expectation
        hit = (self.block_size + req.expected_hit * (self.prompt_len - self.block_size)) / self.prompt_len
        return Request(self._rid, req.stage, toks, hit)

    # ------------------------------------------------------------- warmup
    def warmup_prompts(self, total_tokens: int) -> Iterator[List[int]]:
        """Tagged prompts covering every tenant's corpus round-robin until
        ~``total_tokens`` have been issued."""
        issued = 0
        i = 0
        while issued < total_tokens:
            t = i % self.n_tenants
            corpus = self.tenants[t].corpus
            p = self.tag_block(t) + list(corpus[(i // self.n_tenants) % len(corpus)])
            yield p
            issued += len(p)
            i += 1

    # ------------------------------------------------------------ requests
    def stage_requests(self, stage_idx: int) -> List[Request]:
        hit = self.stages[stage_idx]
        return [
            self._wrap(i % self.n_tenants, self.tenants[i % self.n_tenants]._make_request(stage_idx, hit))
            for i in range(self.requests_per_stage)
        ]

    def requests(self) -> Iterator[Request]:
        for si in range(len(self.stages)):
            yield from self.stage_requests(si)
