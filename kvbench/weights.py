"""Weights made on the device from the seed, in the type they are served
in (bf16), one ``normal_`` call per leaf with one ``torch.Generator`` on
the device.  The same tensors are handed to the program and, layer by layer
upcast, to the reference (``kvbench/reference.py``).

Layout (the program's parameter tree for a dense GQA decoder):
``embed`` (V, D); ``blocks`` with every leaf stacked over layers:
``attn_norm``, ``mlp_norm`` (L, D), ``attn`` {``wq`` (L, D, H·Dh), ``wk``,
``wv`` (L, D, KVH·Dh), ``wo`` (L, H·Dh, D), and ``bq``/``bk``/``bv`` where
the model has q/k/v bias, ``q_norm``/``k_norm`` (L, Dh) where it has
QK-norm}, ``mlp`` {``w_gate``, ``w_up`` (L, D, F), ``w_down`` (L, F, D)};
``final_norm`` (D,); ``lm_head`` (D, V).

Scales: a matrix is N(0, 1/fan_in) with fan_in its next-to-last dim (the
embedding's is V); a norm's scale is 1; a bias is N(0, 0.02²).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch

BIAS_STD = 0.02
NORMS = ("attn_norm", "mlp_norm", "final_norm", "q_norm", "k_norm")
BIASES = ("bq", "bk", "bv")


def shapes(model: Dict) -> Dict:
    """The parameter tree's shapes for the ``model`` object of a config file."""
    L, D, H, KVH = model["n_layers"], model["d_model"], model["n_heads"], model["n_kv_heads"]
    Dh, F, V = model["d_head"], model["d_ff"], model["vocab_size"]
    attn = {"wq": (L, D, H * Dh), "wk": (L, D, KVH * Dh), "wv": (L, D, KVH * Dh), "wo": (L, H * Dh, D)}
    if model["qkv_bias"]:
        attn.update(bq=(L, H * Dh), bk=(L, KVH * Dh), bv=(L, KVH * Dh))
    if model["qk_norm"]:
        attn.update(q_norm=(L, Dh), k_norm=(L, Dh))
    return {
        "embed": (V, D),
        "blocks": {"attn_norm": (L, D), "mlp_norm": (L, D), "attn": attn,
                   "mlp": {"w_gate": (L, D, F), "w_up": (L, D, F), "w_down": (L, F, D)}},
        "final_norm": (D,),
        "lm_head": (D, V),
    }


def _leaves(tree: Dict, prefix: str = "") -> Iterator[Tuple[str, Tuple[int, ...]]]:
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def count(model: Dict) -> int:
    n = 0
    for _, shape in _leaves(shapes(model)):
        size = 1
        for s in shape:
            size *= s
        n += size
    return n


def make(model: Dict, seed: int, device) -> Dict:
    """The parameter tree for ``model``, drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    out: Dict = {}
    for path, shape in _leaves(shapes(model)):
        name = path.rsplit(".", 1)[-1]
        t = torch.empty(shape, dtype=torch.bfloat16, device=device)
        if name in NORMS:
            t.fill_(1.0)
        elif name in BIASES:
            t.normal_(0.0, BIAS_STD, generator=gen)
        else:
            t.normal_(0.0, shape[-2] ** -0.5, generator=gen)
        node = out
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return out
