"""Decoder-LM assembly for the dense (GQA or MLA attention), moe, rwkv6
and hybrid families: one forward covering train (no cache), prefill (cache
fill at a reused-prefix offset) and decode (single step), and the training
loss.  Layers are stacked on a leading L axis, as in the reference, and
driven by a Python loop in place of ``lax.scan``.  The encdec family
(Whisper) is assembled in ``models/encdec.py``.

Under ``common.tensor_parallel`` with a ``model`` axis over 1 the forward,
with or without a cache, splits where the reference constrains: the
layers' sites (``layers.py``), and the logits over the vocabulary
(``lm_head`` columns, uneven where ``model`` does not divide V), with the
cross-entropy taken over the split vocabulary.  The embedding's gather, rwkv6's
blocks and the hybrid's Mamba-2 blocks have no site and run whole on every
rank, their recurrent states whole in every rank's cache.

The reference's ``cfg.seq_shard`` splits the residual stream over
sequence between blocks.  Here, where ``common.splits_sequence`` holds
(the training forward of the dense and moe families, ``model`` over 1
and dividing S), each model rank takes its ``S / model`` rows after the
embedding (``common.split_rows``: the embedding table's gradient stays
whole on every rank), the blocks run on those rows, gathering the
sequence where each split begins and reduce-scattering it where the
split's partial sums leave (``layers.py``), so activation checkpointing
saves the rows, and the final norm's output is gathered for the logits.
rwkv6 and the hybrid keep the stream whole, as the reference, which
constrains it in neither family's blocks, does.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.utils.checkpoint

from .common import (Spec, current_tp, enter_split, mean_over_batch, mean_over_seq, on_rows, reduce_from_model,
                     sequence_split, split_range, split_rows, splits_sequence, tree_init, under_current_mesh)
from .layers import (F32, PAGE, build_gqa_template, build_mla_template, build_mlp_template,
                     build_moe_template, decode_index, gqa_attention, mla_attention, moe_layer,
                     rms_norm, swiglu_mlp)
from .ssm import (build_mamba2_template, build_rwkv6_template, mamba2_init_state, mamba2_mix,
                  mamba2_state_specs, rwkv6_channel_mix, rwkv6_init_state, rwkv6_state_specs,
                  rwkv6_time_mix)

PORTED = ("dense", "moe", "mla", "rwkv6", "hybrid", "encdec")


def require_ported(cfg) -> None:
    kind = "mla" if cfg.attention == "mla" else cfg.family
    if kind not in PORTED:
        raise NotImplementedError(f"{cfg.name}: the port has no {kind} family")


# ------------------------------------------------------------- templates
def build_block_template(cfg) -> Dict:
    require_ported(cfg)
    if cfg.family == "rwkv6":
        return {
            "ln1": Spec((cfg.d_model,), init="ones"),
            "ln2": Spec((cfg.d_model,), init="ones"),
            **build_rwkv6_template(cfg),
        }
    if cfg.family == "hybrid":
        return {
            "norm": Spec((cfg.d_model,), init="ones"),
            "mamba": build_mamba2_template(cfg),
        }
    attn = build_mla_template(cfg) if cfg.attention == "mla" else build_gqa_template(cfg)
    if cfg.family == "moe":
        return {
            "attn_norm": Spec((cfg.d_model,), init="ones"),
            "attn": attn,
            "moe_norm": Spec((cfg.d_model,), init="ones"),
            "moe": build_moe_template(cfg),
        }
    return {
        "attn_norm": Spec((cfg.d_model,), init="ones"),
        "attn": attn,
        "mlp_norm": Spec((cfg.d_model,), init="ones"),
        "mlp": build_mlp_template(cfg),
    }


def stacked(template, L: int):
    if isinstance(template, dict):
        return {k: stacked(v, L) for k, v in template.items()}
    return Spec((L,) + template.shape, template.dtype, template.init, template.scale)


def build_lm_template(cfg) -> Dict:
    D, V = cfg.d_model, cfg.vocab_size
    t = {
        "embed": Spec((V, D), scale=1.0),
        "blocks": stacked(build_block_template(cfg), cfg.n_layers),
        "final_norm": Spec((D,), init="ones"),
        "lm_head": Spec((D, V)),
    }
    if cfg.family == "hybrid":
        # one shared transformer block, reused at every site (Zamba2)
        t["shared_attn"] = {
            "attn_norm": Spec((D,), init="ones"),
            "attn": build_gqa_template(cfg),
            "mlp_norm": Spec((D,), init="ones"),
            "mlp": build_mlp_template(cfg),
        }
    return t


def lm_init(cfg, seed: int = 0, device="cuda"):
    return tree_init(build_lm_template(cfg), seed, device)


# ----------------------------------------------------------------- caches
def n_attn_sites(cfg) -> int:
    """Attention layers that keep a k/v cache: every layer of a dense model,
    ⌈L / attn_every⌉ shared-block sites of a hybrid."""
    if cfg.family != "hybrid":
        return cfg.n_layers
    return (cfg.n_layers + cfg.attn_every - 1) // cfg.attn_every


def cache_len(max_seq: int) -> int:
    """Cache slots for ``max_seq`` tokens, rounded up to a whole number of
    decode pages: decode views each layer's cache as PAGE-token pages.  The
    extra slots always sit at or past kv_len and are masked."""
    return -(-max_seq // PAGE) * PAGE


def cache_specs(cfg, batch: int, max_seq: int) -> Dict:
    """Shapes and dtypes of the serve-time cache (the object the LSM store
    persists block-wise): bf16 k/v of shape (sites, B, S, KVH, Dh) for the
    GQA layers, MLA's bf16 latent c (L, B, S, kv_lora_rank) and kr (L, B,
    S, qk_rope_dim), and the recurrent states of rwkv6 and hybrid.  S is
    ``cache_len(max_seq)``."""
    require_ported(cfg)
    if cfg.family == "rwkv6":
        return rwkv6_state_specs(cfg, batch)
    if cfg.attention == "mla":
        S = cache_len(max_seq)
        return {"c": ((cfg.n_layers, batch, S, cfg.kv_lora_rank), torch.bfloat16),
                "kr": ((cfg.n_layers, batch, S, cfg.qk_rope_dim), torch.bfloat16)}
    shape = (n_attn_sites(cfg), batch, cache_len(max_seq), cfg.n_kv_heads, cfg.d_head)
    if cfg.family == "hybrid":
        return {**mamba2_state_specs(cfg, batch),
                "attn_k": (shape, torch.bfloat16), "attn_v": (shape, torch.bfloat16)}
    return {"k": (shape, torch.bfloat16), "v": (shape, torch.bfloat16)}


def init_cache(cfg, batch: int, max_seq: int, device="cuda"):
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in cache_specs(cfg, batch, max_seq).items()}


# ---------------------------------------------------------------- forward
def embed_tokens(embed, tokens):
    """Row lookup with ids clamped to [0, V-1]: the reference's gather
    clamps out-of-range ids the same way (``e[[V + 5]]`` is the last row),
    while torch's indexing would raise on the CPU and assert on the card."""
    return embed[tokens.clamp(0, embed.shape[0] - 1)]


def unstack(tree, n: int):
    """The ``n`` per-layer trees of a stacked parameter tree, each leaf
    unbound once along its leading L axis.  The backward of an unbind is one
    stack of the per-layer gradients; indexing each layer (``leaf[i]``)
    instead would write a zero-filled full-size gradient per layer for
    autograd to add up."""
    if isinstance(tree, dict):
        per_key = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: per_key[k][i] for k in tree} for i in range(n)]
    return tree.unbind(0)


def checkpointed(block, remat: bool):
    """``block`` itself, or ``block`` under activation checkpointing when
    ``remat``: its activations are recomputed in the backward instead of
    kept (the reference's ``jax.checkpoint`` of the layer-scan body).  The
    forward values are the same either way.  The recomputation runs
    under the tensor-parallel context of the forward."""
    if not remat:
        return block
    return functools.partial(torch.utils.checkpoint.checkpoint, under_current_mesh(block), use_reentrant=False)


def check_pos(pos, S: int, cache) -> None:
    """A tensor ``pos`` is for a single-token decode over a cache: prefill
    slices the cache and offsets flash at ``pos``, which must be known on
    the host (the reference prefills at a static 0 as well)."""
    if isinstance(pos, torch.Tensor) and (S != 1 or cache is None or pos.dim() != 0):
        raise ValueError("a tensor pos must be 0-d and is taken by decode (S == 1 with a cache) only; "
                         f"got S={S}, cache={'none' if cache is None else 'given'}, pos shape {tuple(pos.shape)}")


def _store(cache, i: int, **states) -> None:
    """Write layer ``i``'s new states into the cache, in place."""
    for name, t in states.items():
        cache[name][i].copy_(t)


def lm_forward(params, cfg, tokens, pos: int = 0, cache: Optional[Dict] = None,
               plain_kernels: bool = False):
    """tokens (B,S) int.  ``cache=None`` => training forward.  Otherwise the
    cache is consumed and updated in place at offset ``pos``: an int, or
    for a decode step (S == 1) also a 0-d integer tensor on the model's
    device, which a captured step (``repro_torch.graphs.capture``) reads anew on
    every replay.  ``plain_kernels`` runs every kernel's plain version instead of the
    kernel.  Returns (logits (B,S,V), cache, aux); aux["aux_loss"] is an
    f32 scalar tensor, the sum over moe layers of the reference's
    mean-prob balance proxy n_experts·Σ me², me = probs.mean(0) (zero for
    the other families).  MoE runs dropless whenever a cache is passed.

    Under a tensor-parallel context (``common.tensor_parallel``) the logits
    are this rank's vocabulary columns (``vocab_logits``), a cache is read
    and written through views of this rank's heads (``layers.py``), and
    each moe layer's ``me`` is the mean over the batch axes' ranks
    (``common.mean_over_batch``): the reference's term over the global
    batch.  Where ``common.splits_sequence`` holds, the residual stream
    between blocks is the rank's rows of the sequence (the module's
    docstring), and ``me`` the mean over every row
    (``common.mean_over_seq``)."""
    require_ported(cfg)
    S = tokens.shape[1]
    check_pos(pos, S, cache)
    tp = current_tp()
    with sequence_split(tp is not None and splits_sequence(cfg, S, tp.model_size, cache is not None)):
        return _lm_forward(params, cfg, tokens, pos, cache, plain_kernels)


def _lm_forward(params, cfg, tokens, pos, cache, plain_kernels):
    B, S = tokens.shape
    x = embed_tokens(params["embed"], tokens)
    tp = current_tp()
    if tp is not None and tp.seq_split:
        x = split_rows(x, tp)
    dev = x.device
    positions = (pos + torch.arange(S, dtype=torch.int32, device=dev))[None, :].expand(B, S)
    layers = unstack(params["blocks"], cfg.n_layers)
    aux = torch.zeros((), dtype=F32, device=dev)

    remat = cfg.remat and cache is None  # the reference checkpoints the cache-free scan body

    if cfg.family == "rwkv6":
        live = cache if cache is not None else rwkv6_init_state(cfg, B, dev)

        def rwkv6_block(x, bp, tshift, wkv, cshift):
            h, (tshift, wkv) = rwkv6_time_mix(bp["time"], cfg, rms_norm(x, bp["ln1"]), (tshift, wkv),
                                              plain_kernels)
            x = x + h
            h, cshift = rwkv6_channel_mix(bp["chan"], cfg, rms_norm(x, bp["ln2"]), cshift)
            return x + h, tshift, wkv, cshift

        block = checkpointed(rwkv6_block, remat)
        for i in range(cfg.n_layers):
            x, tshift, wkv, cshift = block(x, layers[i], live["time_shift"][i], live["wkv"][i],
                                           live["chan_shift"][i])
            if cache is not None:
                _store(cache, i, time_shift=tshift, wkv=wkv, chan_shift=cshift)

    elif cfg.family == "hybrid":
        live = cache if cache is not None else mamba2_init_state(cfg, B, dev)
        sp = params["shared_attn"]
        index = None
        if cache is not None and S == 1:
            index = decode_index(B, cache["attn_k"].shape[2], pos + 1, dev)

        def hybrid_block(x, bp, conv, ssm, i):
            h, (conv, ssm) = mamba2_mix(bp["mamba"], cfg, rms_norm(x, bp["norm"]), (conv, ssm), plain_kernels)
            x = x + h
            if i % cfg.attn_every == 0:  # shared attention site i // attn_every
                site = i // cfg.attn_every
                site_cache = None if cache is None else (cache["attn_k"][site], cache["attn_v"][site], pos)
                h, _ = gqa_attention(sp["attn"], cfg, rms_norm(x, sp["attn_norm"]), positions, site_cache,
                                     q_offset=pos, plain_kernels=plain_kernels, index=index)
                x = x + h
                x = x + swiglu_mlp(sp["mlp"], rms_norm(x, sp["mlp_norm"]))
            return x, conv, ssm

        block = checkpointed(hybrid_block, remat)
        for i in range(cfg.n_layers):
            x, conv, ssm = block(x, layers[i], live["conv"][i], live["ssm"][i], i)
            if cache is not None:
                _store(cache, i, conv=conv, ssm=ssm)

    else:
        mla = cfg.attention == "mla"
        index = None
        if cache is not None and S == 1 and not mla:
            index = decode_index(B, cache["k"].shape[2], pos + 1, dev)

        def attn_block(x, aux, bp, i):
            h = rms_norm(x, on_rows(bp["attn_norm"]))
            if mla:
                layer_cache = None if cache is None else (cache["c"][i], cache["kr"][i], pos)
                h, _ = mla_attention(bp["attn"], cfg, h, positions, layer_cache,
                                     q_offset=pos, plain_kernels=plain_kernels)
            else:
                layer_cache = None if cache is None else (cache["k"][i], cache["v"][i], pos)
                h, _ = gqa_attention(bp["attn"], cfg, h, positions, layer_cache,
                                     q_offset=pos, plain_kernels=plain_kernels, index=index)
            x = x + h
            if cfg.family == "moe":
                h, probs = moe_layer(bp["moe"], cfg, rms_norm(x, on_rows(bp["moe_norm"])), dropless=cache is not None)
                x = x + h
                me = mean_over_batch(mean_over_seq(probs.mean(dim=0)))
                aux = aux + cfg.n_experts * torch.sum(me * me)  # the reference's mean-prob balance proxy
            else:
                x = x + swiglu_mlp(bp["mlp"], rms_norm(x, on_rows(bp["mlp_norm"])))
            return x, aux

        block = checkpointed(attn_block, remat)
        for i in range(cfg.n_layers):
            x, aux = block(x, aux, layers[i], i)

    x = rms_norm(x, on_rows(params["final_norm"]))
    logits = vocab_logits(x, params["lm_head"])
    return logits, cache, {"aux_loss": aux}


def vocab_logits(x, w):
    """x @ w: the logits; under a tensor-parallel context this rank's
    columns of the vocabulary (``split_range`` of w's V), x entering the
    split through ``common.enter_split`` (gathered from the rank's rows
    while the stream is split over sequence)."""
    tp = current_tp()
    if tp is None:
        return torch.matmul(x, w)
    lo, hi = split_range(w.shape[1], tp.model_size, tp.model_rank)
    return torch.matmul(enter_split(x, tp), w[:, lo:hi])


# ------------------------------------------------------------------- loss
def token_cross_entropy(logits, labels, vocab_size: Optional[int] = None):
    """Mean -log p(label) in f32 over the positions whose label is >= 0
    (the rest are masked out); 0 when every label is masked.  Under a
    tensor-parallel context ``logits`` are this rank's columns of the
    ``vocab_size`` (``vocab_logits``), and log p(label) is taken over the
    split vocabulary (``split_log_prob``)."""
    tp = current_tp()
    if tp is None:
        logp = torch.log_softmax(logits.to(F32), dim=-1)
        ll = torch.gather(logp, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    else:
        ll = split_log_prob(logits, labels.clamp(min=0), vocab_size, tp)
    mask = (labels >= 0).to(F32)
    return -(ll * mask).sum() / mask.sum().clamp(min=1.0)


def split_log_prob(logits, labels, vocab_size: int, tp):
    """log p(label) from each model rank's vocabulary columns of the
    logits: z_label - m - log Σ exp(z - m), with the max m taken over
    ``model`` (constant under differentiation: the result does not depend
    on it), and the sum of exponentials and the label's logit (which only
    the rank owning the label holds; the others add 0) summed over
    ``model`` in f32 (``reduce_from_model``)."""
    lo, hi = split_range(vocab_size, tp.model_size, tp.model_rank)
    z = logits.to(F32)
    m = z.detach().amax(dim=-1) if hi > lo else z.new_full(z.shape[:-1], -torch.inf)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=tp.model_group)
    sum_exp = reduce_from_model(torch.exp(z - m[..., None]).sum(dim=-1), tp)
    own = (labels >= lo) & (labels < hi)
    local = torch.gather(z, -1, torch.where(own, labels - lo, 0).long()[..., None])[..., 0]
    z_label = reduce_from_model(torch.where(own, local, 0.0), tp)
    return z_label - m - torch.log(sum_exp)


def lm_loss(params, cfg, batch, aux_weight: float = 0.01, plain_kernels: bool = False):
    """Training loss of a decoder LM on ``batch`` (tokens and labels, each
    (B,S)): the cache-free forward, token cross-entropy plus ``aux_weight``
    times the moe balance term -> (loss, {"ce", "aux"})."""
    logits, _, aux = lm_forward(params, cfg, batch["tokens"], plain_kernels=plain_kernels)
    ce = token_cross_entropy(logits, batch["labels"], cfg.vocab_size)
    return ce + aux_weight * aux["aux_loss"], {"ce": ce, "aux": aux["aux_loss"]}
