"""The metric readers on synthetic records: percentiles over every request,
rates over the whole window, and a stall inside the window moving them."""

import numpy as np
import pytest

from kvbench import cell as cellmod, roofline


def rec(ttft, prompt=4096, io_wait=0.0, compute=0.15):
    return {"ttft_s": ttft, "prompt_len": prompt, "io_wait_s": io_wait, "compute_s": compute}


def serve_run(ttfts, window=30.0, stall=0.0):
    return {"window_s": window, "requests": [rec(t) for t in ttfts],
            "commit": {"stall_s": stall, "drain_s": 0.4, "completed_bytes": 8 * 655360},
            "block_bytes": 655360, "wchar": 6 * 655360, "fetch_s": [0.2, 0.4],
            "cache": {"tokens_hit_device": 300, "tokens_hit_host": 100, "tokens_hit_disk": 600},
            "prefill_flops": 7.3e13, "flash_call": (1.0e11, 1.0e8), "profile": None, "setup_s": 42.0}


def read(name, run):
    return cellmod.reader(name)(run)


def test_percentiles_over_all_requests():
    t = list(np.linspace(0.1, 1.0, 100))
    run = serve_run(t)
    assert read("ttft_p50_ms", run) == pytest.approx(np.percentile(t, 50) * 1e3)

    # slow requests in the window move the median once they are half of them
    assert read("ttft_p50_ms", serve_run(t[:60] + [5.0] * 40)) == pytest.approx(read("ttft_p50_ms", run))
    assert read("ttft_p50_ms", serve_run(t[:49] + [5.0] * 51)) == pytest.approx(5000.0)


def test_rates_over_the_whole_window():
    run = serve_run([0.3] * 60, window=30.0)
    assert read("prompt_tokens_per_s.host", run) == pytest.approx(60 * 4096 / 30.0)
    # a stall that costs requests lowers the rate: the window does not shrink
    assert read("prompt_tokens_per_s.host", serve_run([0.3] * 40, window=30.0)) < read("prompt_tokens_per_s.host", run)
    assert read("commit.stall_share", serve_run([0.3], stall=3.0)) == pytest.approx(10.0)


def test_store_and_cache_readers():
    run = serve_run([0.3] * 4)
    assert read("store.commit_ms_per_block", run) == pytest.approx(0.4 / 8 * 1e3)
    assert read("store.write_amp", run) == pytest.approx(6 / 8)
    assert read("cache.disk_hit_share", run) == pytest.approx(60.0)
    assert read("cache.fetch_ms", run) == pytest.approx(300.0)
    assert read("engine.io_wait_ms", run) == pytest.approx(0.0)
    assert read("prefill_ms", run) == pytest.approx(150.0)
    assert read("prefill_mfu", run) == pytest.approx(7.3e13 / (0.15 * 989e12) * 100)
    assert read("store.write_amp", dict(run, wchar=None)) is None
    assert read("cache.fetch_ms", dict(run, fetch_s=[])) is None


def test_trace_readers_leave_out_what_they_cannot_read():
    run = serve_run([0.3])
    for name in ("flash_roofline", "idle_share.serve"):
        assert read(name, run) is None
    prof = {"window_s": 2.0, "busy_s": 1.5, "kernels": {"flash": [40, 0.02], "paged_decode": [0, 0.0]}}
    run["profile"] = prof
    assert read("idle_share.serve", run) == pytest.approx(25.0)
    assert read("flash_roofline", run) == pytest.approx(40 * roofline.bound_s(1.0e11, 1.0e8)[0] / 0.02 * 100)
    prof["kernels"]["flash"] = [0, 0.0]
    assert read("flash_roofline", run) is None  # never a 0 for a roofline share


def test_decode_readers():
    run = {"window_s": 30.0, "requests": [{"decode_s": 7.5, "prefill_s": 0.1, "steps": 512}] * 3,
           "decode_bound_s": 4.3, "paged_decode_bound_s": 0.002, "setup_s": 30.0,
           "profile": {"window_s": 1.0, "busy_s": 0.98, "kernels": {"flash": [0, 0.0], "paged_decode": [5120, 0.01]}}}
    assert read("decode_ms_per_token", run) == pytest.approx(7.5 / 512 * 1e3)
    assert read("decode_mfu", run) == pytest.approx(4.3 / 7.5 * 100)
    assert read("paged_decode_roofline", run) == pytest.approx(20.0)
    assert read("idle_share.decode", run) == pytest.approx(2.0)
    assert read("setup_s", run) == 30.0
