"""Fresh prompts: every request a prompt of ``prompt_tokens`` ids drawn
uniformly from [0, vocab), shared with nothing, and ``output_tokens``
greedy tokens to generate (the traffic file's ``generator`` object)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    tokens: List[int]
    output_tokens: int


class Fresh:
    def __init__(self, params: Dict, vocab: int, seed: int):
        self.prompt_tokens = int(params["prompt_tokens"])
        self.output_tokens = int(params["output_tokens"])
        self.vocab = int(vocab)
        self.rng = np.random.default_rng(int(seed))
        self._rid = 0

    @property
    def prompt_len(self) -> int:
        return self.prompt_tokens

    def requests(self) -> Iterator[Request]:
        while True:
            self._rid += 1
            toks = self.rng.integers(0, self.vocab, size=self.prompt_tokens, dtype=np.int64)
            yield Request(self._rid, toks.tolist(), self.output_tokens)
