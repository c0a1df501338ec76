"""Prompt tokens of every request completed in the window, over the
window's seconds.  A per-layer number: in the document-QA cells the card
idles most of the window and the host paces this rate, which spreads from
run to run wider than an end-to-end bound can hold; under the closed loop
it moves with ``ttft_p50_ms``."""


def read(run):
    return float(sum(r["prompt_len"] for r in run["requests"]) / run["window_s"])
