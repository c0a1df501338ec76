"""A dense decoder with grouped-query attention (glm4-9b, qwen3-14b): the
reference is ``kvbench/reference.py``, the operations and bytes are
``kvbench/roofline.py``'s, and the program stores each layer's keys and
values.

Weights (the program's parameter tree): ``embed`` (V, D); ``blocks`` with
every leaf stacked over layers: ``attn_norm``, ``mlp_norm`` (L, D),
``attn`` {``wq`` (L, D, H·Dh), ``wk``, ``wv`` (L, D, KVH·Dh), ``wo``
(L, H·Dh, D), and ``bq``/``bk``/``bv`` where the model has q/k/v bias,
``q_norm``/``k_norm`` (L, Dh) where it has QK-norm}, ``mlp`` {``w_gate``,
``w_up`` (L, D, F), ``w_down`` (L, F, D)}; ``final_norm`` (D,);
``lm_head`` (D, V).  A matrix is N(0, 1/fan_in) with fan_in its
next-to-last dim (the embedding's is V); a norm's scale is 1; a bias is
N(0, 0.02²).

Stored blocks: ``(block, 2·L·KVH·Dh)`` float16, k then v, each the
(L, block, KVH, Dh) slab reshaped as numpy's ``reshape(block, -1,
order="F")`` does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import reference, roofline

KERNELS = ["flash_attention", "decode_attention"]
TEST_SIZES = {
    "smoke": {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_head": 16, "d_ff": 128,
              "vocab_size": 256},
    "control": {"n_layers": 16, "d_model": 256, "n_heads": 4, "n_kv_heads": 2, "d_head": 64, "d_ff": 512,
                "vocab_size": 2048},
}
BIAS_STD = 0.02
NORMS = ("attn_norm", "mlp_norm", "final_norm", "q_norm", "k_norm")
BIASES = ("bq", "bk", "bv")
F32 = torch.float32


def check_config(cfg, config: Dict) -> None:
    m = config["model"]
    for key in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_head", "d_ff", "vocab_size",
                "qk_norm", "qkv_bias", "rope_theta"):
        if getattr(cfg, key) != m[key]:
            raise ValueError(f"{config['name']}: the program runs {key}={getattr(cfg, key)}, the file says {m[key]}")
    if cfg.family != "dense" or cfg.attention != "gqa" or cfg.dtype != "bfloat16":
        raise ValueError(f"{config['name']}: the harness's reference is a dense GQA decoder in bf16")


def shapes(model: Dict) -> Dict:
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


def init(name: str, shape: Tuple[int, ...]) -> Tuple[str, float]:
    if name in NORMS:
        return "fill", 1.0
    if name in BIASES:
        return "normal", BIAS_STD
    return "normal", shape[-2] ** -0.5


def forward(params: Dict, model: Dict, tokens: torch.Tensor, *, logits_at=None, precision: str = "f32",
            on_state=None) -> Optional[torch.Tensor]:
    on_kv = None if on_state is None else (lambda i, k, v: on_state(i, {"k": k, "v": v}))
    return reference.forward(params, model, tokens, logits_at=logits_at, precision=precision, on_kv=on_kv)


def unpack_blocks(blocks: List, model: Dict, device) -> Optional[Dict[str, torch.Tensor]]:
    L, KVH, Dh = model["n_layers"], model["n_kv_heads"], model["d_head"]
    half = L * KVH * Dh
    if any(b is None or np.ndim(b) != 2 or np.shape(b)[1] != 2 * half for b in blocks):
        return None
    if not blocks:
        empty = torch.empty((L, 0, KVH, Dh), dtype=F32, device=device)
        return {"k": empty, "v": empty}
    x = torch.from_numpy(np.stack([np.asarray(b, dtype=np.float16) for b in blocks])).to(device, F32)
    n, blk = x.shape[:2]
    out = {}
    for j, name in enumerate(("k", "v")):
        # a block's slab is (block, L·KVH·Dh) in Fortran order over (L, block, KVH, Dh)
        slab = x[:, :, j * half:(j + 1) * half].transpose(1, 2).reshape(n, Dh, KVH, blk, L)
        out[name] = slab.permute(4, 0, 3, 2, 1).reshape(L, n * blk, KVH, Dh)
    return out


def block_bytes(model: Dict, block: int) -> int:
    return block * 2 * model["n_layers"] * model["n_kv_heads"] * model["d_head"] * 2


prefill_flops = roofline.prefill_flops
flash_call = roofline.flash_call
decode_step = roofline.decode_step
paged_decode_call = roofline.paged_decode_call
