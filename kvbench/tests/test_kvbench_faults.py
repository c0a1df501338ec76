"""The rest of a run, with the timed path broken underneath, comes out not
correct: once for each fault the cells can have.

Engine cells: the hook returns the cache as it was before the step (zeros),
leaves half of the fresh blocks out, or alters an answer where it is
produced (a block's values); where the cell serves prefixes from disk, the
store returns altered blocks.  Decode
cell: the step returns its state unchanged (its position never advances),
or a served token is altered where it is produced.  Every cell runs on one
chip, so no exchange between chips exists to leave out; its batch is one
request, so no half of a batch."""

import numpy as np
import pytest
import torch

from kvbench import run as kvrun
from kvbench.cell import ROOT, load_json
from kvbench.tests.smoke import smoke_cell

WL = load_json(ROOT / "BENCHMARK.json")["workloads"]
ENGINE = [w["name"] for w in WL if load_json(ROOT / "kvbench" / "traffic" / f"{w['traffic']}.json")["runner"]
          == "engine_loop"]
DECODE = [w["name"] for w in WL if w["name"] not in ENGINE]


def serves_from_disk(name):
    """Whether the cell's tiers hold less than its corpus, so that prefixes
    come back from the store (where they hold it all, what the store
    returns is never served)."""
    tr = load_json(ROOT / "kvbench" / "traffic" / f"{name.split('.', 1)[1]}.json")
    g = tr["generator"]["params"]
    return tr["tiers"]["device_blocks"] + tr["tiers"]["host_blocks"] < g["documents"] * g["doc_tokens"] // g["block"]


def zeros(hook):
    def f(tokens, reused):
        blocks, s = hook(tokens, reused)
        return [np.zeros_like(b) for b in blocks], s
    return f


def half(hook):
    def f(tokens, reused):
        blocks, s = hook(tokens, reused)
        return blocks[: len(blocks) // 2], s
    return f


def altered(hook):
    def f(tokens, reused):
        blocks, s = hook(tokens, reused)
        if blocks:
            b = blocks[-1].copy()
            b[3] = -b[3]
            blocks = blocks[:-1] + [b]
        return blocks, s
    return f


def altered_store(get_batch):
    def f(tokens, n, start_block=0):
        return [b * np.float16(1.5) for b in get_batch(tokens, n, start_block=start_block)]
    return f


def frozen(decode):
    def f(params, tokens, cache, pos):
        out = decode(params, tokens, cache, pos)
        pos -= 1  # greedy_decode advances it after the step: it stays where it was
        return out
    return f


def token_altered(decode):
    calls = [0]

    def f(params, tokens, cache, pos):
        logits, c = decode(params, tokens, cache, pos)
        calls[0] += 1
        if calls[0] % 3 == 0:
            logits = logits.clone()
            logits[..., (int(logits.argmax()) + 7) % logits.shape[-1]] = logits.max() + 1
        return logits, c
    return f


def run(name, faults):
    return kvrun.run_cell(smoke_cell(name), 2**31 + 3, 1.0, False, torch.device("cpu"), faults=faults)


@pytest.mark.parametrize("name", ENGINE)
@pytest.mark.parametrize("fault", [zeros, half, altered])
def test_engine_fault_is_not_correct(name, fault):
    out = run(name, {"hook": fault})
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", [n for n in ENGINE if serves_from_disk(n)])
def test_store_fault_is_not_correct(name):
    out = run(name, {"get_batch": altered_store})
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", DECODE)
@pytest.mark.parametrize("fault", [frozen, token_altered])
def test_decode_fault_is_not_correct(name, fault):
    out = run(name, {"decode": fault})
    assert not out["correct"], out["checks"]
