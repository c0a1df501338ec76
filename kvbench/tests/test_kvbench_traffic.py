"""The traffic generators: seeded, block-aligned, each request's reuse exact."""

import itertools

import numpy as np
import pytest

from kvbench.cell import HERE, load_json
from kvbench.traffic.docqa import DocQA
from kvbench.traffic.fresh import Fresh

PARAMS = {"documents": 4, "doc_tokens": 64, "question_tokens": 16, "zipf": 0.8, "block": 16}


def take(gen, n):
    return list(itertools.islice(gen.requests(), n))


def test_docqa_same_seed_same_requests():
    a, b = DocQA(PARAMS, 1000, 2**33 + 5), DocQA(PARAMS, 1000, 2**33 + 5)
    assert [r.tokens for r in a.warmup()] == [r.tokens for r in b.warmup()]
    assert [r.tokens for r in take(a, 50)] == [r.tokens for r in take(b, 50)]
    c = DocQA(PARAMS, 1000, 2**33 + 6)
    assert [r.tokens for r in take(c, 5)] != [r.tokens for r in take(DocQA(PARAMS, 1000, 2**33 + 5), 5)]


def test_docqa_prefixes_block_aligned_and_reuse_exact():
    g = DocQA(PARAMS, 1000, 7)
    warm = g.warmup()
    assert [r.doc for r in warm] == list(range(4)) and all(r.expected_reuse == 0 for r in warm)
    for r in take(g, 200):
        assert len(r.tokens) == g.prompt_len == 80
        assert r.expected_reuse == 64 and r.expected_reuse % PARAMS["block"] == 0
        assert r.tokens[:64] == g.corpus[r.doc].tolist()
        # the question shares no block with any document: the reuse is exactly the prefix
        q = r.tokens[64:80]
        assert all(q != g.corpus[d, 64 - 16:].tolist() for d in range(4))


def test_docqa_ids_within_vocab_and_zipf_popularity():
    g = DocQA({**PARAMS, "documents": 8}, 151552, 11)
    reqs = take(g, 4000)
    ids = np.array([t for r in reqs for t in r.tokens])
    assert ids.min() >= 0 and ids.max() < 151552
    counts = np.bincount([r.doc for r in reqs], minlength=8)
    order = np.argsort(-g.popularity)
    # the most popular document is drawn most, about 1 / H(8, 0.8) of the time
    assert counts[order[0]] == counts.max()
    assert abs(counts[order[0]] / 4000 - g.popularity[order[0]]) < 0.03


def test_docqa_rejects_unaligned_documents():
    with pytest.raises(ValueError):
        DocQA({**PARAMS, "doc_tokens": 70}, 1000, 0)


def test_fresh_prompts_seeded_and_in_vocab():
    p = {"prompt_tokens": 32, "output_tokens": 8}
    a, b = take(Fresh(p, 500, 3), 10), take(Fresh(p, 500, 3), 10)
    assert [r.tokens for r in a] == [r.tokens for r in b]
    assert all(len(r.tokens) == 32 and r.output_tokens == 8 and max(r.tokens) < 500 for r in a)


@pytest.mark.parametrize("mix", sorted(p.stem for p in (HERE / "traffic").glob("*.json")))
def test_traffic_files_name_their_generator(mix):
    tr = load_json(HERE / "traffic" / f"{mix}.json")
    assert (HERE / "runners" / f"{tr['runner']}.py").exists()
    assert (HERE / "traffic" / f"{tr['generator']['module']}.py").exists()
