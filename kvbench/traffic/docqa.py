"""Document QA: each request is one document's prefix plus a fresh question.

The pattern of documents asked about more than once (arXiv:2506.02634,
Mooncake arXiv:2407.00079), as a corpus of roots with block-aligned shared
prefixes and fresh tails, the shape of the program's
``workload/staged.StagedWorkload`` (copied here and rewritten, so the
benchmark's traffic cannot move with the program).

Parameters (the traffic file's ``generator`` object):
  documents        number of documents in the corpus
  doc_tokens       tokens of each document, a whole number of blocks
  question_tokens  fresh tokens after the document
  zipf             popularity exponent s: document of rank r drawn with
                   weight 1 / r**s; which document has which rank is drawn
                   from the seed
  block            the cache's block size, which doc_tokens must divide

Token ids are drawn uniformly from [0, vocab).  The warm-up serves every
document once, with a question of its own.  Every request's expected
reuse is exactly ``doc_tokens``: its document was written through in the
warm-up and its question is fresh.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    doc: int
    tokens: List[int]
    expected_reuse: int
    stage: int = 0


class DocQA:
    def __init__(self, params: Dict, vocab: int, seed: int):
        self.documents = int(params["documents"])
        self.doc_tokens = int(params["doc_tokens"])
        self.question_tokens = int(params["question_tokens"])
        self.block = int(params["block"])
        if self.doc_tokens % self.block:
            raise ValueError(f"doc_tokens {self.doc_tokens} is not a whole number of {self.block}-token blocks")
        self.vocab = int(vocab)
        self.rng = np.random.default_rng(int(seed))
        self.corpus = self.rng.integers(0, self.vocab, size=(self.documents, self.doc_tokens), dtype=np.int64)
        w = 1.0 / np.arange(1, self.documents + 1, dtype=np.float64) ** float(params["zipf"])
        self.popularity = np.empty(self.documents)
        self.popularity[self.rng.permutation(self.documents)] = w / w.sum()
        self._rid = 0

    @property
    def prompt_len(self) -> int:
        return self.doc_tokens + self.question_tokens

    def _request(self, doc: int, expected_reuse: int) -> Request:
        q = self.rng.integers(0, self.vocab, size=self.question_tokens, dtype=np.int64)
        self._rid += 1
        return Request(self._rid, doc, self.corpus[doc].tolist() + q.tolist(), expected_reuse)

    def warmup(self) -> List[Request]:
        """Every document once, in order, each with a question of its own;
        nothing is cached before them, so each reuses nothing."""
        return [self._request(d, 0) for d in range(self.documents)]

    def requests(self) -> Iterator[Request]:
        while True:
            doc = int(self.rng.choice(self.documents, p=self.popularity))
            yield self._request(doc, self.doc_tokens)
