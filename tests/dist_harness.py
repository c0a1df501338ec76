"""Multi-rank runs of the port's distributed layer on the CPU: gloo ranks
spawned with ``torch.multiprocessing``, each rank running one function of
this module and leaving its results in ``<workdir>/rank<r>.pt``.  The
functions import torch and the port only (no JAX), so the ranks start
quickly; ``tests/test_torch_distributed.py`` holds their results against
the JAX package run in a subprocess on host devices.

The inputs come from numpy with a seed (``inputs``), the same arrays the
JAX side gets.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

N_STAGES, N_MICRO, MB, D = 4, 6, 2, 8  # tests/test_pipeline.py's schedule
GRAD_SHAPES = {"a": (16, 8), "b": (5, 12)}  # a ragged leaf too


def inputs(world: int = 4, seed: int = 0):
    """Per-rank gradients and residuals (rank r's gradient scaled by r + 1,
    so the ranks' scales differ and the max-scale requantization acts),
    the gpipe stage weights and microbatches, and the checkpoint tree."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in GRAD_SHAPES.items():
        out[f"grad_{k}"] = np.stack([rng.standard_normal(shape).astype(np.float32) * (r + 1) for r in range(world)])
        out[f"res_{k}"] = (rng.standard_normal((world,) + shape) * 0.01).astype(np.float32)
    out["w"] = (rng.standard_normal((N_STAGES, D, D)) * 0.3).astype(np.float32)
    out["xs"] = rng.standard_normal((N_MICRO, MB, D)).astype(np.float32)
    out["ckpt_w"] = rng.standard_normal((8, 8)).astype(np.float32)
    out["ckpt_b"] = rng.standard_normal(8).astype(np.float32)  # stored as bf16
    return out


def stage_fn(p, x):
    return torch.tanh(x @ p)


def sequential(w, xs):
    for s in range(w.shape[0]):
        xs = stage_fn(w[s], xs)
    return xs


def _entry(rank, world, store, fn, workdir, args):
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        out = fn(rank, world, workdir, *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, workdir: str, *args, timeout: float = 240.0):
    """``fn(rank, world, workdir, *args)`` on ``world`` gloo ranks; returns
    the list of what each rank returned.  A rank that raises fails the
    run with its traceback; ranks still running at ``timeout`` are
    killed."""
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, "store")
    ctx = mp.start_processes(_entry, args=(world, store, fn, workdir, args), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{fn.__name__} on {world} ranks did not finish in {timeout} s")
    return [torch.load(os.path.join(workdir, f"rank{r}.pt")) for r in range(world)]


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).to(torch.bfloat16)


def four_ranks(rank, world, workdir, inp, ckpt_from_jax, ckpt_for_jax):
    """place, the compressed all-reduce (both forms), gpipe at 4 stages,
    and the elastic restores, on 4 gloo ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.compression import allreduce_compressed, allreduce_quantized, quantize_tensor
    from repro_torch.distributed.pipeline import gpipe
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import api
    from repro_torch.models.common import tree_flatten
    from repro_torch.training import checkpoint as ckpt

    out = {}
    # place: every leaf's local shard is the slice shard_slices names for
    # this rank's coordinate; qwen3 on (data 2, model 2), kimi-k2 with its
    # ZeRO over (pod, data) on (pod 2, data 2, model 1)
    placed_leaves = 0
    for arch, mesh, fsdp in (("qwen3-14b", make_smoke_mesh(2, 2, device="cpu"), ("data",)),
                             ("kimi-k2-1t-a32b", make_smoke_mesh(2, 1, pod=2, device="cpu"), ("pod", "data"))):
        params = api.init_params(get_config(arch, smoke=True), 0, "cpu")
        shs = shd.param_shardings(mesh, params, fsdp)
        placed = shd.place(params, shs)
        coord = tuple(mesh.get_coordinate())
        for t, d, sh in zip(tree_flatten(params)[0], tree_flatten(placed)[0], tree_flatten(shs)[0]):
            assert d.placements == tuple(sh.placements())
            assert torch.equal(d.to_local(), t[sh.shard_slices(tuple(t.shape))[coord]])
            assert torch.equal(d.full_tensor(), t)
            placed_leaves += 1
        out[f"composite_{arch}"] = sum(1 for sh in tree_flatten(shs)[0] for e in sh.spec if isinstance(e, tuple))
    out["placed_leaves"] = placed_leaves
    rows = shd.NamedSharding(make_smoke_mesh(2, 1, pod=2, device="cpu"), shd.P(("pod", "data")))
    out["pod_data_rows"] = rows.place(torch.arange(8.0)).to_local().tolist()

    # the compressed all-reduce over data (4 ranks)
    mesh = make_smoke_mesh(4, 1, device="cpu")
    grads = {k: torch.from_numpy(inp[f"grad_{k}"][rank]) for k in GRAD_SHAPES}
    res = {k: torch.from_numpy(inp[f"res_{k}"][rank]) for k in GRAD_SHAPES}
    reduced, new_res = allreduce_compressed(mesh, grads, res)
    out["reduced"], out["new_res"] = reduced, new_res
    q, s = quantize_tensor(grads["a"])  # tests/test_compression_e2e.py's form: no residual
    out["e2e_q"], out["e2e_s"] = q, s
    out["e2e_reduced"] = allreduce_quantized(mesh, {"a": q}, {"a": s})["a"]

    # gpipe: 4 stages, 6 microbatches
    smesh = init_device_mesh("cpu", (N_STAGES,), mesh_dim_names=("stage",))
    w = torch.from_numpy(inp["w"])
    out["ys"] = gpipe(stage_fn, smesh, axis="stage")(w[rank:rank + 1], torch.from_numpy(inp["xs"]))

    # elastic restore: saved from a (2, 2) mesh, restored onto (4, 1) with
    # another layout; and the reference's (2, 2) checkpoint onto (4, 1)
    m1, m2 = make_smoke_mesh(2, 2, device="cpu"), make_smoke_mesh(4, 1, device="cpu")
    tree = {"w": torch.from_numpy(inp["ckpt_w"]), "b": _bf16(inp["ckpt_b"])}
    sh1 = {"w": shd.NamedSharding(m1, shd.P("data", "model")), "b": shd.NamedSharding(m1, shd.P("model"))}
    sh2 = {"w": shd.NamedSharding(m2, shd.P("model", "data")), "b": shd.NamedSharding(m2, shd.P("data"))}
    ckpt.save(ckpt_for_jax, 3, shd.place(tree, sh1))
    out["restored"] = {}
    for name, d in (("own", ckpt_for_jax), ("jax", ckpt_from_jax)):
        got, manifest = ckpt.restore(d, 3, tree, sh2, device="cpu")
        coord = tuple(m2.get_coordinate())
        for k in tree:
            assert got[k].placements == tuple(sh2[k].placements()), (name, k)
            assert torch.equal(got[k].to_local(), got[k].full_tensor()[sh2[k].shard_slices(tuple(tree[k].shape))[coord]])
        out["restored"][name] = ({k: v.full_tensor() for k, v in got.items()}, manifest["step"])
    return out


def two_ranks(rank, world, workdir, inp, steps, cfg_arch, ckpt_root):
    """The data-parallel train step over data 2 (f32), gpipe at one stage,
    and the data-parallel loop's crash and resume (restored under
    shardings), on 2 gloo ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    from torch.distributed.tensor import Shard

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.pipeline import gpipe
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import api
    from repro_torch.models.common import tree_leaves
    from repro_torch.training import optim
    from repro_torch.training.loop import TrainConfig, default_optimizer, train

    out = {}
    mesh = make_smoke_mesh(world, 1, device="cpu")
    cfg = get_config(cfg_arch, smoke=True)
    params, losses = dp_steps(cfg, steps, mesh)
    out["losses"], out["params"] = losses, params

    # one stage: no ring, the stage function applied to every microbatch
    pmesh = init_device_mesh("cpu", (world, 1), mesh_dim_names=("data", "stage"))
    w, xs = torch.from_numpy(inp["w"]), torch.from_numpy(inp["xs"])
    out["one_stage"] = gpipe(stage_fn, pmesh, axis="stage")(w[:1], xs)
    out["one_stage_want"] = stage_fn(w[0], xs)

    # the loop under the mesh: uninterrupted, then crashed after step 3
    # with checkpoints every 2 and resumed, the checkpoint restored under
    # the ZeRO shardings of the parameters and state; rank 0 alone writes
    quiet = dict(log=lambda *_: None, device="cpu", mesh=mesh)
    tc = dict(steps=6, ckpt_every=2, log_every=100)
    full = train(cfg, TrainConfig(ckpt_dir=os.path.join(ckpt_root, "full"), **tc), **quiet)
    crash_dir = os.path.join(ckpt_root, "crash")
    c1 = train(cfg, TrainConfig(ckpt_dir=crash_dir, **tc), crash_after=3, **quiet)
    p_specs = api.param_specs(cfg)
    o_specs = optim.state_specs(default_optimizer(tc["steps"]), p_specs)
    p_sh = shd.param_shardings(mesh, p_specs)
    shardings = {"params": p_sh, "opt": shd.opt_state_shardings(mesh, o_specs, p_sh)}
    out["sharded_leaves"] = sum(any(isinstance(p, Shard) for p in sh.placements()) for sh in tree_leaves(shardings))
    c2 = train(cfg, TrainConfig(ckpt_dir=crash_dir, **tc), shardings=shardings, **quiet)
    out["loop"] = {"full": full["losses"], "crashed": c1["crashed"], "resumed_from": c2["resumed_from"],
                   "resumed": c2["losses"], "files": sorted(os.listdir(crash_dir))}
    return out


def train_batch(cfg, step: int):
    """The global batch of ``step``: SyntheticLM's 4 x 32 tokens and labels
    from seed 3, and for encdec stub frames (4, enc_frames, d_model) drawn
    from numpy with the seed (3, step)."""
    from repro_torch.training.data import DataConfig, SyntheticLM

    data = SyntheticLM(DataConfig(cfg.vocab_size, seq_len=32, global_batch=4, seed=3))
    batch = {k: torch.from_numpy(a) for k, a in data.batch_at(step).items()}
    if cfg.family == "encdec":
        rng = np.random.default_rng((3, step))
        batch["frames"] = torch.from_numpy(rng.standard_normal((4, cfg.enc_frames, cfg.d_model)).astype(np.float32))
    return batch


def f32_params(cfg):
    """The parameters of seed 0, cast to f32."""
    from repro_torch.models import api

    return _map(lambda t: t.float(), api.init_params(cfg, 0, "cpu"))


def dp_steps(cfg, steps: int, mesh=None, eps: float = 1e-8):
    """``steps`` train steps of ``cfg`` in f32 (``f32_params``) on
    ``train_batch``, AdamW at ``eps``: data- and tensor-parallel under
    ``mesh``, else in one process.  -> (params, losses)."""
    from repro_torch.training import optim
    from repro_torch.training.loop import make_train_step

    params = f32_params(cfg)
    ocfg = optim.OptimizerConfig(warmup_steps=1, total_steps=10, eps=eps)
    state = optim.init_state(ocfg, params)
    step = make_train_step(cfg, ocfg, mesh)
    losses = []
    for s in range(steps):
        params, state, met = step(params, state, train_batch(cfg, s))
        losses.append(float(met["loss"]))
    return params, losses


# the tensor-parallel cases: (arch, overrides of its smoke config).  The
# smoke configs have H 4 and KVH 2, so attention splits over query groups
# at model 2; the overrides add the split over KV heads, uneven heads
# (KVH 3, G 1; KVH 2, G 3), hidden dim (127) and experts (3), qkv biases,
# odd vocabularies and activation checkpointing.  At model 4 the uneven
# cases leave a rank an empty part: no KV head, no query group, no expert
TP_CASES = {
    "dense": ("qwen3-14b", {}),
    "dense_kvh": ("qwen3-14b", {"n_kv_heads": 4}),
    "dense_uneven": ("qwen3-14b", {"n_heads": 3, "n_kv_heads": 3, "d_ff": 127}),
    "dense_groups": ("qwen3-14b", {"n_heads": 6, "n_kv_heads": 2}),
    "bias": ("qwen2.5-32b", {}),
    "odd_vocab": ("qwen3-14b", {"vocab_size": 255}),
    "moe": ("olmoe-1b-7b", {}),
    "moe_uneven": ("olmoe-1b-7b", {"n_experts": 3}),
    "moe_remat": ("olmoe-1b-7b", {"remat": True}),
    "mla": ("minicpm3-4b", {}),
    "hybrid": ("zamba2-1.2b", {}),
    "rwkv6": ("rwkv6-1.6b", {}),
    "whisper": ("whisper-small", {}),
    "whisper_kvh": ("whisper-small", {"n_kv_heads": 4}),
}


def tp_config(case: str):
    import dataclasses

    from repro_torch.configs import get_config

    arch, over = TP_CASES[case]
    return dataclasses.replace(get_config(arch, smoke=True), **over)


# AdamW's eps in the tensor-parallel cases' steps (see
# tests/test_torch_tensor_parallel.py)
TP_EPS = 1e-6


def grads_and_steps(cfg, steps: int, mesh=None):
    """The loss terms and gradients of ``train_batch(cfg, 0)`` at
    ``f32_params`` (``make_grad_fn``), then ``dp_steps`` at ``TP_EPS``;
    under ``mesh`` on this rank, else in one process."""
    from repro_torch.training.loop import make_grad_fn

    loss, parts, grads = make_grad_fn(cfg, mesh)(f32_params(cfg), train_batch(cfg, 0))
    params, losses = dp_steps(cfg, steps, mesh, TP_EPS)
    return {"loss": float(loss), "aux": float(parts["aux"]), "grads": grads, "params": params, "losses": losses}


def tp_ranks(rank, world, workdir, meshes, steps, cached=None):
    """``grads_and_steps`` of each case on each (data, model) mesh of
    ``meshes`` ({(data, model): [case, ...]}), and ``cached_forward`` of
    each case of ``cached`` (the same form, keyed (data, model, case,
    "cached")), on ``world`` gloo ranks."""
    from repro_torch.launch.mesh import make_smoke_mesh

    torch.set_num_threads(1)  # smoke shapes: the ranks would only contend for the cores
    out = {}
    for (data, model), cases in meshes.items():
        mesh = make_smoke_mesh(data, model, device="cpu")
        for case in cases:
            out[(data, model, case)] = grads_and_steps(tp_config(case), steps, mesh)
    for (data, model), cases in (cached or {}).items():
        mesh = make_smoke_mesh(data, model, device="cpu")
        for case in cases:
            out[(data, model, case, "cached")] = cached_forward(tp_config(case), mesh)
    return out


CACHED_B, CACHED_S, CACHED_STEPS = 2, 8, 2  # rows, prompt tokens, greedy decode steps


def gather_vocab(logits, vocab_size: int):
    """The whole logits (..., V) on every rank from each model rank's
    columns (``transformer.vocab_logits``) under a tensor-parallel
    context, ``logits`` itself without one: each rank's part padded to the
    largest, all-gathered over ``model``, cut back and joined in order."""
    from repro_torch.models.common import current_tp, split_range

    tp = current_tp()
    if tp is None:
        return logits
    parts = [split_range(vocab_size, tp.model_size, r) for r in range(tp.model_size)]
    width = max(hi - lo for lo, hi in parts)
    pad = torch.nn.functional.pad(logits, (0, width - logits.shape[-1])).contiguous()
    got = [torch.empty_like(pad) for _ in parts]
    dist.all_gather(got, pad, group=tp.model_group)
    return torch.cat([t[..., :hi - lo] for t, (lo, hi) in zip(got, parts)], dim=-1)


def cached_forward(cfg, mesh=None):
    """Prefill of a seeded (CACHED_B, CACHED_S) prompt into an f32 cache of
    CACHED_S + CACHED_STEPS tokens, then CACHED_STEPS greedy decode steps,
    at ``f32_params``, through the plain versions, under
    ``tensor_parallel(mesh)`` with ``mesh`` (every row on every rank: data
    1), else in one process.  -> the whole logits of each step
    (``gather_vocab``), the tokens, the cache, and this rank's
    KV heads (``layers.gqa_heads``; all of them without a mesh)."""
    import contextlib

    from repro_torch.models import api, layers
    from repro_torch.models.common import current_tp, tensor_parallel

    params = f32_params(cfg)
    rng = np.random.default_rng(11)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (CACHED_B, CACHED_S)).astype(np.int64))
    inputs = {"tokens": tokens}
    if cfg.family == "encdec":
        inputs["frames"] = torch.from_numpy(rng.standard_normal((CACHED_B, cfg.enc_frames, cfg.d_model))
                                            .astype(np.float32))
    cache = _map(lambda t: t.float(), api.init_cache(cfg, CACHED_B, CACHED_S + CACHED_STEPS, "cpu"))
    out = {"logits": [], "tokens": []}
    with torch.no_grad(), (tensor_parallel(mesh) if mesh is not None else contextlib.nullcontext()):
        tp = current_tp()
        out["kv_heads"] = (0, cfg.n_kv_heads) if tp is None or not cfg.n_kv_heads else layers.gqa_heads(cfg, tp)[0]
        logits, cache = api.prefill_fn(cfg, plain_kernels=True)(params, inputs, cache, 0)
        step = api.decode_fn(cfg, plain_kernels=True)
        for i in range(CACHED_STEPS + 1):
            full = gather_vocab(logits, cfg.vocab_size)[:, -1]
            out["logits"].append(full)
            if i == CACHED_STEPS:
                break
            tok = full.argmax(-1, keepdim=True)
            out["tokens"].append(tok)
            logits, cache = step(params, tok, cache, CACHED_S + i)
    out["cache"] = cache
    return out


def launcher_ranks(rank, world, workdir, argv):
    """``launch.train.main(argv)`` on this rank -> its losses."""
    from repro_torch.launch import train as launcher

    torch.set_num_threads(1)
    res = launcher.main(argv + ["--ckpt-dir", os.path.join(workdir, "ckpt")])
    return {"losses": res["losses"]}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def collective_ranks(rank, world, workdir, arch: str, B: int, S: int):
    """The train, prefill and decode steps of ``launch.steps`` (as
    ``lower_cell`` builds them: remat and AdamW, the plain versions) of
    ``arch``'s smoke config at (B, S) on the (2, 2) mesh, on real tensors:
    the bytes each step hands ``dist.all_reduce``,
    ``dist.all_gather_into_tensor`` and ``dist.reduce_scatter_tensor`` on
    this rank, counted around each call by kind, in the cost counter's
    convention (``launch/cost.py``): the operand, which is an all-reduce's
    buffer and the input of the other two.  The batch comes from numpy
    with seed 5."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import api
    from repro_torch.models.common import tensor_parallel
    from repro_torch.training import optim

    torch.set_num_threads(1)
    mesh = make_smoke_mesh(2, 2, device="cpu")
    cfg = get_config(arch, smoke=True)
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)) for k in ("tokens", "labels")}
    rows = shd.batch_shardings(mesh, batch["tokens"]).shard_slices((B, S))[tuple(mesh.get_coordinate())][0]
    sent = {}
    wrapped = {"all_reduce": ("all-reduce", 0), "all_gather_into_tensor": ("all-gather", 1),
               "reduce_scatter_tensor": ("reduce-scatter", 1)}
    originals = {name: getattr(dist, name) for name in wrapped}

    def counted(name):
        kind, at = wrapped[name]

        def call(*args, **kwargs):
            t = args[at]
            if dist.get_world_size(kwargs.get("group")) > 1:  # a group of one rank moves nothing
                sent[kind] = sent.get(kind, 0) + t.numel() * t.element_size()
            return originals[name](*args, **kwargs)

        return call

    def take():
        got = dict(sent)
        sent.clear()
        return got

    out = {}
    for name in wrapped:
        setattr(dist, name, counted(name))
    try:
        step, ocfg = steps.build_train_step(cfg, mesh=mesh)
        params = api.init_params(cfg, 0, "cpu")
        step(params, optim.init_state(ocfg, params), batch)
        out["train"] = take()
        params = api.init_params(cfg, 0, "cpu")
        with torch.no_grad(), tensor_parallel(mesh):
            steps.build_prefill_step(cfg, ShapeConfig("p", S, B, "prefill"), plain_kernels=True)(
                params, {"tokens": batch["tokens"][rows]})
            out["prefill"] = take()
            cache = api.init_cache(cfg, rows.stop - rows.start, S, "cpu")
            steps.build_decode_step(cfg, ShapeConfig("d", S, B, "decode"), plain_kernels=True)(
                params, batch["tokens"][rows, :1], cache, torch.tensor(S - 1, dtype=torch.int32))
            out["decode"] = take()
    finally:
        for name, fn in originals.items():
            setattr(dist, name, fn)
    return out


# the sequence-sharding cases (tests/test_torch_seq_shard.py): the families
# whose residual stream splits over sequence, and those that keep it whole
SEQ_CASES = ("dense", "moe", "mla")
SEQ_WHOLE = ("rwkv6", "hybrid", "whisper")
SEQ_UNEVEN_S = 31  # a sequence model 2 does not divide: the stream stays whole


def seq_config(case: str, seq_shard: bool = True):
    """``tp_config(case)`` with remat on and ``seq_shard`` as given, as the
    train steps set them (``launch/steps.py::_train_cfg``)."""
    import dataclasses

    return dataclasses.replace(tp_config(case), remat=True, seq_shard=seq_shard)


def checkpointed_inputs(cfg, mesh, batch):
    """The loss terms and gradients of ``batch`` under ``mesh``
    (``make_grad_fn``), and the shape of the residual stream each
    activation checkpoint saved: the tensors saved, seen through
    ``torch.autograd.graph.saved_tensors_hooks``, while a checkpoint takes
    its inputs, that are the block's first input."""
    import torch.utils.checkpoint as ckpt

    from repro_torch.training.loop import make_grad_fn

    inputs, saved = [], []
    checkpoint = ckpt.checkpoint

    def recording(fn, x, *args, **kwargs):
        inputs.append(x)
        try:
            return checkpoint(fn, x, *args, **kwargs)
        finally:
            inputs.pop()

    def pack(t):
        if inputs and t.data_ptr() == inputs[-1].data_ptr() and t.shape == inputs[-1].shape:
            saved.append(tuple(t.shape))
        return t

    ckpt.checkpoint = recording
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, parts, grads = make_grad_fn(cfg, mesh)(f32_params(cfg), batch)
    finally:
        ckpt.checkpoint = checkpoint
    return {"loss": float(loss), "aux": float(parts["aux"]), "grads": grads, "saved": saved}


def seq_shard_ranks(rank, world, workdir, meshes):
    """On each (data, model) mesh of ``meshes`` ({(data, model): (cases,
    whole_cases)}): each of ``cases`` with ``seq_shard`` on and off
    (``checkpointed_inputs``), and on at ``SEQ_UNEVEN_S`` tokens; each of
    ``whole_cases`` with ``seq_shard`` on and off; on ``world`` gloo ranks.
    -> {(data, model, case, "on" | "off" | "uneven"): result}."""
    from repro_torch.launch.mesh import make_smoke_mesh

    torch.set_num_threads(1)
    out = {}
    for (data, model), (cases, whole) in meshes.items():
        mesh = make_smoke_mesh(data, model, device="cpu")
        for case in cases + whole:
            for on in (True, False):
                cfg = seq_config(case, on)
                out[(data, model, case, "on" if on else "off")] = checkpointed_inputs(cfg, mesh, train_batch(cfg, 0))
        for case in cases:
            cfg = seq_config(case)
            batch = {k: v[:, :SEQ_UNEVEN_S] for k, v in train_batch(cfg, 0).items()}
            out[(data, model, case, "uneven")] = checkpointed_inputs(cfg, mesh, batch)
    return out


# ------------------------------------- the decode step over a rank's KV heads
VIEW_B, VIEW_S, VIEW_PROMPT = 2, 32, 8  # rows, cache slots (two 16-slot pages a row), prompt tokens


def decode_page_views(rank, world, workdir, cases):
    """Under ``tensor_parallel`` at (data, model) = (1, world): a prefill of
    VIEW_PROMPT tokens and one decode step of each case in bf16 through the
    kernels' wrappers (their plain versions on the CPU), recording the k
    and v pages ``layers.decode_over_cache`` hands ``paged_decode``: whether
    they share the cache's storage, their offset in it and strides (in
    elements), whether they are contiguous, and what
    ``decode_attention.page_strides`` reads off them.  -> {case:
    {"kv_heads", "pages": [per call {"k": ..., "v": ...}], "cache_numel"}}."""
    from repro_torch.kernels.decode_attention import page_strides
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import api, layers
    from repro_torch.models.common import current_tp, tensor_parallel

    torch.set_num_threads(1)
    mesh = make_smoke_mesh(1, world, device="cpu")
    real, out = layers.paged_decode, {}
    for case in cases:
        cfg = tp_config(case)
        params = api.init_params(cfg, 0, "cpu")
        cache = api.init_cache(cfg, VIEW_B, VIEW_S, "cpu")
        seen = []

        def describe(pages, leaf):
            return {"shares_storage": pages.untyped_storage().data_ptr() == leaf.untyped_storage().data_ptr(),
                    "offset": pages.storage_offset(), "strides": pages.stride(), "shape": tuple(pages.shape),
                    "contiguous": pages.is_contiguous(), "page_strides": page_strides("pages", pages)}

        def recording(q, kp, vp, tables, lens):
            seen.append({"k": describe(kp, cache["k"]), "v": describe(vp, cache["v"])})
            return real(q, kp, vp, tables, lens)

        tokens = torch.from_numpy(np.random.default_rng(11).integers(0, cfg.vocab_size, (VIEW_B, VIEW_PROMPT)))
        layers.paged_decode = recording
        try:
            with torch.no_grad(), tensor_parallel(mesh):
                _, cache = api.prefill_fn(cfg)(params, {"tokens": tokens}, cache, 0)
                api.decode_fn(cfg)(params, tokens[:, :1], cache, VIEW_PROMPT)
                kv = layers.gqa_heads(cfg, current_tp())[0]
        finally:
            layers.paged_decode = real
        out[case] = {"kv_heads": kv, "pages": seen, "cache_shape": tuple(cache["k"].shape)}
    return out


def _nest(flat):
    """{'a/b': array} -> {'a': {'b': f32 tensor}}."""
    tree = {}
    for path, a in flat.items():
        *head, last = path.split("/")
        d = tree
        for k in head:
            d = d.setdefault(k, {})
        d[last] = torch.from_numpy(np.asarray(a, np.float32))
    return tree


def cached_steps_ranks(rank, world, workdir, inp_path, cases, data: int, n_steps: int):
    """The port's prefill, then ``n_steps`` greedy decode steps through
    ``launch.steps.build_decode_step`` (``pos`` a 0-d int32 tensor), with
    the kernels' wrappers (their plain versions on the CPU), under
    ``tensor_parallel`` of the (data, world / data) mesh, at the f32
    parameters and (B, S) tokens ``inp_path`` holds for each case (the JAX
    package's, by key path).  The prefill is ``build_prefill_step``'s body
    (``api.prefill_fn`` at 0 into a fresh cache of S + n_steps slots, the
    last token's logits) with the cache in f32.  This rank takes its rows
    of the batch (``sharding.batch_shardings``).  -> {case: {"rows",
    "logits": [(rows, V) whole, ``gather_vocab``] per step, "tokens": [(rows,
    1)] per decode step}}."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import api
    from repro_torch.models.common import tensor_parallel

    torch.set_num_threads(1)
    mesh = make_smoke_mesh(data, world // data, device="cpu")
    inp = dict(np.load(inp_path))
    out = {}
    for case in cases:
        cfg = tp_config(case)
        pre = f"{case}|p|"
        params = _nest({k[len(pre):]: v for k, v in inp.items() if k.startswith(pre)})
        tokens = torch.from_numpy(inp[f"{case}|tokens"]).long()
        B, S = tokens.shape
        rows = shd.batch_shardings(mesh, tokens).shard_slices((B, S))[tuple(mesh.get_coordinate())][0]
        decode = steps.build_decode_step(cfg, ShapeConfig("d", S + n_steps, B, "decode"))
        cache = _map(lambda t: t.float(), api.init_cache(cfg, rows.stop - rows.start, S + n_steps, "cpu"))
        res = {"rows": (rows.start, rows.stop), "logits": [], "tokens": []}
        with torch.no_grad(), tensor_parallel(mesh):
            logits, cache = api.prefill_fn(cfg)(params, {"tokens": tokens[rows]}, cache, 0)
            last = logits[:, -1]
            for i in range(n_steps + 1):
                full = gather_vocab(last, cfg.vocab_size)
                res["logits"].append(full)
                if i == n_steps:
                    break
                tok = full.argmax(-1, keepdim=True)
                res["tokens"].append(tok)
                last, cache = decode(params, tok, cache, torch.tensor(S + i, dtype=torch.int32))
        out[case] = res
    return out


def chip_smoke_decode_ranks(rank, world, workdir):
    """``chip_smoke.py``'s phase tensor-parallel part (d) on this rank,
    rehearsed on the CPU: the smoke configs of its archs at (data, model)
    = (1, world), results to ``workdir``."""
    import sys

    from repro_torch.launch.mesh import make_smoke_mesh

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    torch.set_num_threads(1)
    chip_smoke._tp_decode_rank(workdir, rank, make_smoke_mesh(1, world, device="cpu"), device="cpu", smoke=True)
