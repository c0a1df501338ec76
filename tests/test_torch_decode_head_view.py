"""The paged decode kernel over a rank's KV-head view of the cache, on the
CPU.  Under a split over ``model`` each rank attends over the view of its
KV heads of the whole cache (``models/layers.kv_head_view``), which
``decode_over_cache`` hands ``paged_decode`` as pages without a copy.  The
kernel reads such pages in place at the page and slot strides
``kernels/decode_attention/ops.page_strides`` takes off them; that check
runs here, and so does the plain version the wrapper takes on a CPU tensor.
The kernel itself on such views is held against its contiguous copy on the
card (tests/test_torch_cuda_head_view.py).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import dist_harness as dh
from repro_torch.kernels.decode_attention import HEAD_DIMS, kv_page_strides, page_strides, paged_decode, paged_decode_ref
from repro_torch.models import layers
from repro_torch.models.layers import PAGE

DTYPES = [torch.bfloat16, torch.float32]
# (KVH, G, model): a split over KV heads (qwen3-14b's 8 x 5 at model 2:
# 4 KV heads a rank, a strided view), over query groups (glm4-9b's 2 x 16:
# every KV head on each rank, the whole cache), and splits wider than their
# dim at model 4 (KVH 3, G 1: rank 3 holds no KV head; KVH 2, G 3: rank 3
# holds no query group)
SPLITS = [(8, 5, 2), (2, 16, 2), (4, 1, 2), (3, 1, 4), (2, 3, 4)]
B, S = 2, 48  # three 16-slot pages a row


def _ranks(KVH, G, model):
    """Each rank's (KV heads, query groups), as ``layers.gqa_heads`` gives them."""
    cfg = SimpleNamespace(n_heads=KVH * G, n_kv_heads=KVH)
    return [layers.gqa_heads(cfg, SimpleNamespace(model_size=model, model_rank=r)) for r in range(model)]


def _pages(buf, kv):
    """The pages ``decode_over_cache`` makes of a rank's view of ``buf``."""
    view = layers.kv_head_view(buf, kv)
    return view.view(buf.shape[0] * (buf.shape[1] // PAGE), PAGE, kv[1] - kv[0], buf.shape[3])


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("KVH,G,model", SPLITS, ids=[f"kvh{k}_g{g}_model{m}" for k, g, m in SPLITS])
def test_page_strides_take_each_ranks_view(KVH, G, model, D, dtype):
    """Every rank's KV-head view, an empty part of a split included, is
    pages the kernel reads in place, a view of the cache's storage at the
    whole cache's page and slot strides."""
    buf = torch.zeros((B, S, KVH, D), dtype=dtype)
    for kv, _ in _ranks(KVH, G, model):
        pages = _pages(buf, kv)
        assert pages.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()
        assert pages.storage_offset() == kv[0] * D
        got = page_strides("k_pages", pages)
        if kv[1] > kv[0]:  # an empty view's strides are torch's own: it holds nothing to read
            assert got == (PAGE * KVH * D, KVH * D)


@pytest.mark.parametrize("bad,match", [
    ("every_other_head", "contiguous over"),  # heads not adjacent
    ("half_head_dim", "contiguous over"),     # a head's dims cut
    ("start_off_16_bytes", "16 bytes"),
    ("slot_stride_off_16_bytes", "16-byte units"),
])
def test_page_strides_refuse_what_the_kernel_cannot_read(bad, match):
    D = 64
    buf = torch.zeros((B, S, 8, D), dtype=torch.bfloat16)
    if bad == "every_other_head":
        pages = buf[:, :, ::2].view(B * S // PAGE, PAGE, 4, D)
    elif bad == "half_head_dim":
        pages = buf[..., :D // 2].view(B * S // PAGE, PAGE, 8, D // 2)
    elif bad == "start_off_16_bytes":
        pages = torch.zeros(buf.numel() + 1, dtype=torch.bfloat16)[1:].view(B * S // PAGE, PAGE, 8, D)
    else:
        pages = torch.zeros((B * S, D + 1), dtype=torch.bfloat16)[:, :D].view(B * S // PAGE, PAGE, 1, D)
    with pytest.raises(ValueError, match=match):
        page_strides("k_pages", pages)


def test_k_and_v_must_share_their_strides():
    """The kernel reads k and v at one pair of strides: k and v views of
    the same rank take them, k a strided view beside a contiguous v is
    refused."""
    D = 64
    k, v = torch.zeros((B, S, 8, D)), torch.zeros((B, S, 8, D))
    kp, vp = _pages(k, (4, 8)), _pages(v, (4, 8))
    assert kv_page_strides(kp, vp) == (PAGE * 8 * D, 8 * D)
    with pytest.raises(ValueError, match="share their page and slot strides"):
        kv_page_strides(kp, vp.contiguous())


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("KVH,G,model", SPLITS, ids=[f"kvh{k}_g{g}_model{m}" for k, g, m in SPLITS])
def test_plain_version_on_a_view_equals_it_on_the_copy(KVH, G, model, dtype):
    """``paged_decode_ref``, and the wrapper on CPU tensors, on each rank's
    view give its contiguous copy's result bit for bit, over shuffled
    tables, a kv_len = 0 row and a ragged one."""
    D = 64
    rng = np.random.default_rng(KVH * 100 + G)
    k = torch.from_numpy(rng.standard_normal((B, S, KVH, D)).astype(np.float32)).to(dtype)
    v = torch.from_numpy(rng.standard_normal((B, S, KVH, D)).astype(np.float32)).to(dtype)
    NB = S // PAGE
    tables = torch.from_numpy(rng.permutation(B * NB).astype(np.int32)).view(B, NB)
    lens = torch.tensor([0, S - 5], dtype=torch.int32)
    for kv, gs in _ranks(KVH, G, model):
        H = (kv[1] - kv[0]) * (gs[1] - gs[0])
        q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(np.float32)).to(dtype)
        kp, vp = _pages(k, kv), _pages(v, kv)
        want = paged_decode_ref(q, kp.contiguous(), vp.contiguous(), tables, lens)
        assert torch.equal(paged_decode_ref(q, kp, vp, tables, lens), want)
        assert torch.equal(paged_decode(q, kp, vp, tables, lens), want)


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    """What ``decode_over_cache`` hands ``paged_decode`` on each of 2 gloo
    ranks at (data, model) = (1, 2)."""
    return dh.run_ranks(dh.decode_page_views, 2, str(tmp_path_factory.mktemp("views")), ("dense_kvh", "dense"))


@pytest.mark.parametrize("case", ["dense_kvh", "dense"])
def test_decode_hands_paged_decode_a_view_of_the_cache(views, case):
    """Under ``tensor_parallel`` at (1, 2), one decode step passes
    ``paged_decode`` the pages of each layer's cache leaf viewed, not
    copied: they share its storage, start at the rank's first KV head,
    and keep the whole cache's strides.  dense_kvh (KVH 4, G 1) splits
    over KV heads, so each rank's pages are strided; dense (KVH 2, G 2)
    over query groups, so each rank's are the whole leaf."""
    cfg = dh.tp_config(case)
    L, Bc, Sc, KVH, D = views[0][case]["cache_shape"]
    heads = set()
    for got in views:
        r = got[case]
        lo, hi = r["kv_heads"]
        heads |= set(range(lo, hi))
        assert len(r["pages"]) == cfg.n_layers  # one call a layer
        for i, call in enumerate(r["pages"]):
            for which in ("k", "v"):
                pg = call[which]
                assert pg["shares_storage"], (i, which)
                assert pg["offset"] == i * Bc * Sc * KVH * D + lo * D
                assert pg["shape"] == (Bc * Sc // PAGE, PAGE, hi - lo, D)
                assert pg["strides"][:2] == pg["page_strides"] == (PAGE * KVH * D, KVH * D)
                assert pg["contiguous"] == (hi - lo == KVH)
    assert heads == set(range(cfg.n_kv_heads))
    assert (views[0][case]["kv_heads"][1] - views[0][case]["kv_heads"][0] < cfg.n_kv_heads) == (case == "dense_kvh")


def test_chip_smokes_decode_under_model_rehearses_on_the_cpu(tmp_path, capsys):
    """chip_smoke.py's phase tensor-parallel part (d), its ranks and its
    gates, on 2 gloo ranks with the smoke configs of qwen3-14b and
    glm4-9b on the CPU: every rank's logits and cache within the gates
    against one process and the plain path, and no launch (the CPU takes
    the plain versions)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    dh.run_ranks(dh.chip_smoke_decode_ranks, 2, str(tmp_path))
    assert chip_smoke._tp_decode_check(str(tmp_path), "cpu", device="cpu", smoke=True) == (
        {"flash": 0, "paged_decode": 0}, [])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[tensor-parallel] part=d")]
    assert len(lines) == 2 * len(chip_smoke.TP_DECODE_ARCHS)
    assert all("f32_tokens_vs_one_process=True" in ln and "f32_tokens_vs_plain=True" in ln for ln in lines)
