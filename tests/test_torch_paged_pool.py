"""The port's paged KV pool, mirroring tests/test_paged_pool.py: allocator
invariants (hypothesis), staging round-trip, and the pool + paged decode
against dense attention and against the reference's pool + Pallas kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st
from parity_harness import F32_TOL, np32

from repro.kernels.decode_attention import paged_decode as jax_paged_decode
from repro.serving.paged_pool import PagedKVPool as JaxPagedKVPool
from repro_torch.kernels.decode_attention import paged_decode, paged_decode_ref
from repro_torch.serving.paged_pool import PagedKVPool, PoolFullError


def make_pool(n_pages=8, page=4, L=2, KVH=2, D=16):
    return PagedKVPool(n_pages, page, L, KVH, D, device="cpu")


def test_alloc_free_roundtrip():
    pool = make_pool()
    pages = pool.alloc(1, 3)
    assert len(set(pages)) == 3 and pool.free_pages == 5
    pool.free(1)
    assert pool.free_pages == 8


def test_pool_full():
    pool = make_pool(n_pages=2)
    pool.alloc(1, 2)
    with pytest.raises(PoolFullError):
        pool.alloc(2, 1)


@settings(max_examples=25, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 31), st.integers(1, 3)), min_size=1, max_size=16))
def test_allocator_never_double_books(ops):
    """Property: live pages are disjoint and free+live == total."""
    pool = make_pool(n_pages=16)
    live = {}
    for seq_id, n in ops:
        if seq_id in live:
            pool.free(seq_id)
            del live[seq_id]
        else:
            try:
                live[seq_id] = pool.alloc(seq_id, n)
            except PoolFullError:
                continue
        flat = [p for pages in live.values() for p in pages]
        assert len(flat) == len(set(flat))  # disjoint
        assert pool.free_pages + len(flat) == 16


def test_allocator_matches_reference_pool():
    """The same alloc/extend/free sequence hands out the same page ids and
    builds the same padded tables as the reference pool."""
    ops = [("alloc", 1, 3), ("alloc", 2, 2), ("extend", 1), ("free", 2), ("alloc", 3, 4), ("extend", 3)]
    ours, ref = make_pool(n_pages=12), JaxPagedKVPool(12, 4, 2, 2, 16)
    for op in ops:
        for pool in (ours, ref):
            getattr(pool, op[0])(*op[1:])
    assert ours.free_pages == ref.free_pages
    np.testing.assert_array_equal(ours.block_tables([1, 3]).numpy(), ref.block_tables([1, 3]))


def test_staging_and_kernel_agree_with_dense():
    """Promote blocks into the pool, run the paged decode per layer, and
    compare with dense attention over the same KV and with the reference's
    pool + Pallas kernel (interpret mode) fed the same blocks."""
    rng = np.random.default_rng(0)
    L, KVH, D, page = 2, 2, 32, 4
    H = 4
    pool = make_pool(n_pages=16, page=page, L=L, KVH=KVH, D=D)
    ref_pool = JaxPagedKVPool(16, page, L, KVH, D)
    seqs = {10: 7, 11: 10}  # seq_id -> token count
    dense = {}
    for sid, n_tok in seqs.items():
        for p in (pool, ref_pool):
            p.alloc(sid, -(-n_tok // page))
        k = rng.standard_normal((L, n_tok, KVH, D)).astype(np.float16)
        v = rng.standard_normal((L, n_tok, KVH, D)).astype(np.float16)
        dense[sid] = (k, v)
        # stage page-aligned blocks (as the hierarchy promotion does)
        for off in range(0, n_tok, page):
            end = min(off + page, n_tok)
            pool.stage_block(sid, off, torch.from_numpy(k[:, off:end]), torch.from_numpy(v[:, off:end]))
            ref_pool.stage_block(sid, off, k[:, off:end], v[:, off:end])
        assert pool.seq_len(sid) == n_tok

    sids = list(seqs)
    tables, lens = pool.block_tables(sids), pool.kv_lens(sids)
    assert tables.dtype == torch.int32 and lens.dtype == torch.int32
    qn = rng.standard_normal((len(sids), H, D)).astype(np.float32)
    q = torch.from_numpy(qn)

    for layer in range(L):
        kp, vp = (t.float() for t in pool.layer_view(layer))
        assert kp.shape == (16, page, KVH, D) and pool.layer_view(layer)[0].is_contiguous()
        out = paged_decode(q, kp, vp, tables, lens)
        np.testing.assert_allclose(np32(out), np32(paged_decode_ref(q, kp, vp, tables, lens)),
                                   rtol=F32_TOL, atol=F32_TOL)
        rkp, rvp = ref_pool.layer_view(layer)
        want = jax_paged_decode(jnp.asarray(qn), jnp.asarray(rkp, jnp.float32), jnp.asarray(rvp, jnp.float32),
                                jnp.asarray(ref_pool.block_tables(sids)), jnp.asarray(ref_pool.kv_lens(sids)),
                                interpret=True)
        np.testing.assert_allclose(np32(out), np32(want), rtol=F32_TOL, atol=F32_TOL)
        # dense cross-check for each sequence
        for i, sid in enumerate(sids):
            k, v = dense[sid]
            kf, vf = torch.from_numpy(k[layer]).float(), torch.from_numpy(v[layer]).float()
            qf = q[i].reshape(KVH, H // KVH, D)
            p = torch.softmax(torch.einsum("kgd,tkd->kgt", qf, kf) / D**0.5, dim=-1)
            o = torch.einsum("kgt,tkd->kgd", p, vf)
            np.testing.assert_allclose(np32(out)[i], np32(o.reshape(H, D)), rtol=2e-3, atol=2e-3)


def test_append_token_extends_pages():
    pool = make_pool(n_pages=4, page=2, L=1, KVH=1, D=8)
    pool.alloc(5, 1)
    for t in range(5):  # crosses two page boundaries
        k = torch.full((1, 1, 8), float(t), dtype=torch.float16)
        pool.append_token(5, k, k)
    assert pool.seq_len(5) == 5
    assert len(pool.block_tables([5])[0]) == 3
    kp, _ = pool.layer_view(0)
    table = pool.block_tables([5])[0]
    assert kp[table[2], 0, 0, 0] == 4  # 5th token on the 3rd page


def test_pool_lives_on_the_device_it_was_given():
    pool = make_pool()
    assert pool.k_pages.device.type == "cpu"
    assert PagedKVPool.__dataclass_fields__["device"].default == "cuda"
