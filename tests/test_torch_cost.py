"""The per-op cost counter (``repro_torch.launch.cost``), the port's
counterpart of the reference's ``launch/hlocost.py``: single ops on meta
tensors against their analytic FLOPs and bytes, ten chained matmuls
counted ten times (``tests/test_hlocost.py::test_scan_trip_count_multiplies_flops``'s
case), views counted as nothing, the peak of live storages, and
collectives under a fake process group.  Every count is exact."""

import pytest
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import AbstractMesh
from repro_torch.launch.cost import CostCounter, count
from repro_torch.launch.mesh import fake_mesh

META = torch.device("meta")
F32, BF16 = torch.float32, torch.bfloat16


def _t(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device=META)


@pytest.mark.parametrize("M,K,N", [(128, 512, 64), (7, 3, 5)])
def test_matmul_is_2mnk_and_reads_its_operands(M, K, N):
    a, b = _t(M, K), _t(K, N, dtype=F32)
    _, t = count(torch.matmul, a, b)
    assert t.flops == t.matmul_flops == 2 * M * N * K
    assert t.bytes == 4 * (M * K + K * N + M * N)


def test_batched_matmul_and_einsum():
    a, b = _t(3, 16, 32, dtype=BF16), _t(3, 32, 8, dtype=BF16)
    _, t = count(torch.bmm, a, b)
    assert t.matmul_flops == 2 * 3 * 16 * 8 * 32
    _, t = count(torch.einsum, "bij,bjk->bik", a, b)
    assert t.matmul_flops == 2 * 3 * 16 * 8 * 32


def test_elementwise_is_one_flop_an_output_element():
    x, y = _t(64, 32), _t(64, 32)
    _, t = count(torch.tanh, x)
    assert (t.flops, t.matmul_flops, t.bytes) == (64 * 32, 0, 2 * 4 * 64 * 32)
    _, t = count(torch.add, x, y)
    assert (t.flops, t.bytes) == (64 * 32, 3 * 4 * 64 * 32)


def test_reduction_is_one_flop_an_input_element():
    x = _t(64, 32)
    _, t = count(torch.sum, x, dim=-1)
    assert t.flops == 64 * 32 and t.bytes == 4 * (64 * 32 + 64)
    _, t = count(torch.softmax, x, -1)  # max, subtract, exp, sum, divide
    assert t.flops == 5 * 64 * 32


def test_gather_counts_the_rows_it_reads_not_the_table():
    """A 151936 x 5120 bf16 table (qwen3-14b's embedding, 1.56 GB) and 3
    ids: 3 rows read and written, and the ids."""
    table, ids = _t(151936, 5120, dtype=BF16), torch.empty(3, dtype=torch.int64, device=META)
    for fn in (lambda: table[ids], lambda: torch.nn.functional.embedding(ids, table),
               lambda: table.index_select(0, ids)):
        _, t = count(fn)
        assert t.bytes == 2 * 3 * 5120 * 2 + 3 * 8 and t.flops == 0


def test_in_place_scatter_and_copy_count_the_rows_they_move():
    """One token written into a (2, 4096, 8, 128) cache: its rows read and
    written and its index, not the cache; a slice copied in once each way."""
    cache, new = _t(2, 4096, 8, 128, dtype=BF16), _t(2, 1, 8, 128, dtype=BF16)
    pos = torch.empty(1, dtype=torch.int64, device=META)
    row = 2 * 8 * 128 * 2
    _, t = count(lambda: cache.index_copy_(1, pos, new))
    assert t.bytes == 2 * row + 8
    _, t = count(lambda: cache[:, 7:8].copy_(new))
    assert t.bytes == 2 * row


def test_views_and_metadata_cost_nothing():
    x = _t(8, 16, 32)

    def views():
        return x.view(128, 32).t().reshape(32, 8, 16).transpose(0, 1).unbind(0)[0].expand(4, 32, 16)[1:3].detach()

    _, t = count(views)
    assert (t.flops, t.bytes) == (0, 0) and t.ops > 5


def test_ten_chained_matmuls_count_ten_times():
    """A Python loop dispatches its body once per trip: ten (256, 256)
    matmuls and tanhs, as hlocost's scan of ten counts them."""
    x, w = _t(256, 256), _t(256, 256)

    def chain():
        c = x
        for _ in range(10):
            c = torch.tanh(c @ w)
        return c

    _, t = count(chain)
    assert t.matmul_flops == 10 * 2 * 256**3
    assert t.flops == 10 * (2 * 256**3 + 256**2)


def test_peak_live_bytes_follow_storages_to_their_release():
    """Two 1 MB temporaries alive at once, then one freed before a third:
    the peak is 2 MB, and views of a temporary add nothing."""
    mb = 256 * 1024  # f32 elements in a MiB

    def step():
        a = torch.zeros(mb, device=META)
        b = a + 1
        va = a.view(512, 512)
        del a, va
        c = b * 2
        return c

    _, t = count(step)
    assert t.peak_live_bytes == 2 * 4 * mb


def test_backward_is_counted():
    """The backward of a matmul is two matmuls of the same size."""
    a = _t(32, 64).requires_grad_(True)
    b = _t(64, 16).requires_grad_(True)

    def fwd_bwd():
        return torch.autograd.grad((a @ b).sum(), (a, b))

    _, t = count(fwd_bwd)
    assert t.matmul_flops == 3 * 2 * 32 * 64 * 16


def test_an_all_reduce_under_a_fake_group_is_counted_once_with_its_bytes():
    """(16, 16) as rank 0 of a fake group of 256: an all-reduce over
    ``model`` (16 consecutive ranks, two 8-card hosts) and one over
    ``data`` are each counted once, by kind and axis, with their operand
    bytes, both across hosts; a group of one rank moves nothing."""
    from repro_torch.launch.cost import axes_of

    x = _t(4, 1024)
    with fake_mesh(AbstractMesh((16, 16), ("data", "model"))) as dm:
        with CostCounter(axes_of(dm)) as c:
            dist.all_reduce(x, group=dm.get_group("model"))
            dist.all_reduce(x[:1], group=dm.get_group("data"))
            dist.all_reduce(x, group=dist.new_group([0]))
    t = c.totals
    assert dict(t.coll_count_by_op) == {"all-reduce": 2}
    assert dict(t.coll_bytes_by_op) == {"all-reduce": 4 * 4096 + 4 * 1024}
    assert dict(t.coll_bytes_by_axis) == {"model": 4 * 4096, "data": 4 * 1024}
    assert t.coll_cross_host_bytes == t.collective_bytes and t.bytes == 0
    assert not dist.is_initialized()


def test_a_group_inside_one_host_stays_on_nvlink():
    """(2, 4) in a fake group of 8: every group lies in one 8-card host."""
    from repro_torch.launch.cost import axes_of

    with fake_mesh(AbstractMesh((2, 4), ("data", "model"))) as dm:
        with CostCounter(axes_of(dm)) as c:
            dist.all_reduce(_t(16), group=dm.get_group("model"))
            dist.all_gather_into_tensor(_t(8), _t(2), group=dm.get_group("model"))
    t = c.totals
    assert dict(t.coll_bytes_by_op) == {"all-reduce": 64, "all-gather": 8}
    assert t.coll_cross_host_bytes == 0


def test_inference_mode_counts_what_no_grad_counts():
    """Under inference mode composite ops (matmul, einsum) reach the
    counter whole; it counts the ops they decompose into, so a forward
    counts the same under inference mode as under no_grad."""
    a, b, c = _t(4, 8, 16), _t(16, 32), _t(4, 32, 8)

    def fwd():
        return torch.einsum("bij,bjk->bik", torch.matmul(a, b), c).sum()

    with torch.no_grad():
        _, want = count(fwd)
    with torch.inference_mode():
        _, got = count(fwd)
    assert got.matmul_flops == want.matmul_flops == 2 * 4 * 8 * 32 * 16 + 2 * 4 * 8 * 8 * 32
    assert (got.flops, got.bytes) == (want.flops, want.bytes)


def test_saved_bytes_are_what_the_backward_keeps():
    """A tanh's output is saved for its backward; under activation
    checkpointing only the checkpoint's input is, and a parameter (an
    argument of the step) never counts.  The peak names the op that set
    it."""
    import torch.utils.checkpoint

    w = _t(256, 256).requires_grad_(True)
    x = _t(64, 256).requires_grad_(True)

    def block(h):
        return torch.tanh(torch.tanh(h @ w))

    def step(remat):
        h = x * 2  # the block's input, made by the step
        y = torch.utils.checkpoint.checkpoint(block, h, use_reentrant=False) if remat else block(h)
        return torch.autograd.grad(y.sum(), (x, w))

    _, plain = count(step, False)
    _, remat = count(step, True)
    act = 4 * 64 * 256
    assert plain.saved_bytes == 3 * act  # h for the matmul, both tanh outputs
    assert remat.saved_bytes == act  # the checkpoint's input
    assert plain.peak_op and plain.peak_op.startswith("aten.")



@pytest.mark.parametrize("moment_dtype,factored", [("float32", False), ("bfloat16", False), ("bfloat16", True)],
                         ids=["f32-moments", "bf16-m", "bf16-m-factored-v"])
def test_the_fused_adamw_update_reads_and_writes_each_leaf_once(moment_dtype, factored):
    """The optimizer on meta, as the card runs it (``kernels/adamw``): a
    leaf's ``adamw_update`` is one op that reads p, g, m and v (or vr, vc
    and the divisor) and the step's 4 scalars once and writes p, m and v
    once; the whole step allocates no f32 temporary of a leaf (its
    largest storages are its few scalars), so a dry run's peak sees none."""
    from repro_torch.kernels import adamw
    from repro_torch.training import optim

    ocfg = optim.OptimizerConfig(moment_dtype=moment_dtype, factored_second_moment=factored)
    L, R, C = 4, 64, 32
    n = L * R * C
    p, g, scalars = _t(L, R, C, dtype=BF16), _t(L, R, C, dtype=BF16), _t(4)
    state = optim.init_state(ocfg, {"w": p})
    m, v, mb = state["m"]["w"], state["v"]["w"], state["m"]["w"].element_size()
    hyper = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    if factored:
        denom = adamw.factored_stats(g, v["vr"], v["vc"], scalars, 0.95)
        _, t = count(adamw.adamw_update, p, g, m, None, scalars, vr=v["vr"], vc=v["vc"], denom=denom, **hyper)
        reads, writes = (2 + 2 + mb) * n + 4 * (L * R + L * C + L + 4), (2 + mb) * n
    else:
        _, t = count(adamw.adamw_update, p, g, m, v["v"], scalars, **hyper)
        reads, writes = (2 + 2 + mb + 4) * n + 4 * 4, (2 + mb + 4) * n
    assert (t.ops, t.bytes, t.flops, t.peak_live_bytes) == (1, reads + writes, n, 0)
    _, t = count(optim.apply_updates, ocfg, {"w": p}, {"w": g}, state)
    assert 0 < t.peak_live_bytes < 64
