"""The yardstick's arithmetic, frozen with the benchmark: the H100's peaks
and the operations and bytes of the steps and kernels the cells run,
computed from shapes.  Copied from the program's ``launch/mesh.py``
constants and the bound arithmetic of ``chip_smoke.py`` (``_flash_bound``,
``_decode_bound``), so a change to the program cannot move them.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense, at the full 700 W
limit: 989e12 FLOP/s in bf16 on the tensor cores, 3.35e12 B/s of HBM3.
"""

from __future__ import annotations

from typing import Dict, Tuple

PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
BF16 = 2


def bound_s(flops: float, nbytes: float) -> Tuple[float, str]:
    """The least time the chip could take, and which peak sets it."""
    c, m = flops / PEAK_FLOPS_BF16, nbytes / HBM_BW
    return (c, "flops") if c >= m else (m, "bytes")


def causal_pairs(S: int, q_offset: int = 0) -> int:
    """(query, key) pairs a causal attention of S queries at q_offset visits."""
    return S * q_offset + S * (S + 1) // 2


def layer_matmul_flops(model: Dict, tokens: int) -> float:
    """One block's projections and MLP for ``tokens`` tokens."""
    D, H, KVH, Dh, F = (model[k] for k in ("d_model", "n_heads", "n_kv_heads", "d_head", "d_ff"))
    return 2.0 * tokens * (D * H * Dh + 2 * D * KVH * Dh + H * Dh * D + 3 * D * F)


def prefill_flops(model: Dict, S: int) -> float:
    """A prefill of S tokens from position 0 that yields the KV cache and the
    last token's logits: every block over S tokens, causal attention (q·k
    and p·v), and the output head for one token.  Work a step does beyond
    that (logits for every position) is not counted."""
    H, Dh = model["n_heads"], model["d_head"]
    attn = 4.0 * H * Dh * causal_pairs(S)
    return model["n_layers"] * (layer_matmul_flops(model, S) + attn) + 2.0 * model["d_model"] * model["vocab_size"]


def flash_call(model: Dict, S: int, q_offset: int = 0) -> Tuple[float, float]:
    """(flops, bytes) of one causal flash call: q and o of S rows, k and v of
    q_offset + S rows, bf16, each read or written once."""
    H, KVH, Dh = model["n_heads"], model["n_kv_heads"], model["d_head"]
    Skv = q_offset + S
    nbytes = BF16 * (2 * S * H * Dh + 2 * Skv * KVH * Dh)
    return 4.0 * H * Dh * causal_pairs(S, q_offset), float(nbytes)


def paged_decode_call(model: Dict, kv_len: int, page: int = 16) -> Tuple[float, float]:
    """(flops, bytes) of one paged decode call at B 1: q and o, k and v of
    kv_len tokens, the block table and length."""
    H, KVH, Dh = model["n_heads"], model["n_kv_heads"], model["d_head"]
    nb = -(-kv_len // page)
    nbytes = BF16 * 2 * H * Dh + BF16 * 2 * kv_len * KVH * Dh + 4 * nb + 4
    return 4.0 * H * Dh * kv_len, float(nbytes)


def decode_step(model: Dict, kv_len: int) -> Tuple[float, float]:
    """(flops, bytes) of one greedy decode step at B 1 over kv_len cached
    tokens (the new one included): every block's weights read once, the
    output head read once, one embedding row, the KV read and the new
    token's KV written."""
    L, D, KVH, Dh, V = (model[k] for k in ("n_layers", "d_model", "n_kv_heads", "d_head", "vocab_size"))
    H = model["n_heads"]
    layer_params = (D * H * Dh + 2 * D * KVH * Dh + H * Dh * D + 3 * D * model["d_ff"] + 2 * D
                    + (2 * Dh if model["qk_norm"] else 0) + ((H + 2 * KVH) * Dh if model["qkv_bias"] else 0))
    flops = L * (layer_matmul_flops(model, 1) + 4.0 * H * Dh * kv_len) + 2.0 * D * V
    nbytes = BF16 * (L * layer_params + D * V + D + D) + BF16 * L * 2 * KVH * Dh * (kv_len + 1)
    return flops, float(nbytes)
