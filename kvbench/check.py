"""The comparison that decides ``correct``: what the timed path produced,
held against the plain reference (the architecture module's ``forward``,
``kvbench/arch/``) run once the window has closed, on the same weights and
token ids.

KV blocks (the ``engine_loop`` runner).  The architecture module reads a
block back from the layout the program stores (``unpack_blocks``) into the
parts of each layer's state (k and v for GQA).  For every sampled request,
every layer and every part apart, the number is
``max|program − reference| / max|reference|`` over that layer's part of
the request's blocks:

  kv_fresh_err     the blocks the prefill hook handed to the cache (and so
                   to the store), the tokens after the reused prefix
  kv_promoted_err  the blocks the request took back from the tiers (device,
                   host, or disk through the LSM lookup and the codec)

each the largest over the sample; a block missing or of the wrong count
reads ``inf``.  Over every request of the window, not only the sample,
``reuse_mismatches`` counts those whose reused tokens differ from what
their traffic built, and ``blocks_missing`` the blocks taken back without
data (each limit 0).

Greedy decode (the ``greedy`` runner).  The reference runs each sampled
request's prompt followed by the tokens fed to the decode; at every
position that served a token:

  decode_gap        (reference's best logit − reference's logit of the
                    served token) / std of the reference's logits there
  decode_logit_err  max|program's logits − reference's| / std of the
                    reference's logits, over the decode steps' rows

each the largest over the sample.
"""

from __future__ import annotations

import math
from types import ModuleType
from typing import Dict, List, Optional

import torch


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    if x.shape != ref.shape:
        return math.inf
    if x.numel() == 0:
        return 0.0
    return float((x - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def kv_numbers(arch: ModuleType, params: Dict, model: Dict, samples: List[Dict], block: int, device,
               control: bool = False) -> Dict[str, Dict[str, float]]:
    """``samples``: dicts with ``tokens`` (the prompt), ``reused`` (tokens the
    program took from the cache), ``fresh`` (the hook's blocks) and
    ``promoted`` (the cache's blocks of the reused prefix).  Returns
    {"program": numbers} and, with ``control``, {"control": numbers} of the
    reference in fp8 put in the program's place."""
    out = {"program": {"kv_fresh_err": 0.0, "kv_promoted_err": 0.0}}
    if not samples:
        out["program"] = {"kv_fresh_err": math.inf, "kv_promoted_err": math.inf}
        return out
    S = len(samples[0]["tokens"])
    if any(len(s["tokens"]) != S for s in samples):
        raise ValueError("the sample's prompts differ in length")
    tokens = torch.tensor([s["tokens"] for s in samples], dtype=torch.long, device=device)
    progs = []
    for s in samples:
        start, nb = s["reused"] // block, S // block
        fresh = arch.unpack_blocks(s["fresh"], model, device) if len(s["fresh"]) == nb - start else None
        prom = arch.unpack_blocks(s["promoted"], model, device) if len(s["promoted"]) == start else None
        progs.append((start * block, nb * block, fresh, prom))
    num = out["program"]
    kept: List = [None] * model["n_layers"] if control else None

    def compare(i, parts):
        for b, (r0, r1, fresh, prom) in enumerate(progs):
            for name, x in parts.items():
                ref = x[b]
                num["kv_fresh_err"] = max(num["kv_fresh_err"], math.inf if fresh is None
                                          else rel_err(fresh[name][i], ref[r0:r1]))
                num["kv_promoted_err"] = max(num["kv_promoted_err"], math.inf if prom is None
                                             else rel_err(prom[name][i], ref[:r0]))
        if kept is not None:
            kept[i] = {name: x.clone() for name, x in parts.items()}

    arch.forward(params, model, tokens, on_state=compare)
    if control:
        ctl = {"kv_fresh_err": 0.0, "kv_promoted_err": 0.0}

        def compare_ctl(i, parts):
            refs = kept[i]
            for b, (r0, r1, _, _) in enumerate(progs):
                for name, x in parts.items():
                    xb, ref = x[b], refs[name][b]
                    ctl["kv_fresh_err"] = max(ctl["kv_fresh_err"], rel_err(xb[r0:r1], ref[r0:r1]))
                    ctl["kv_promoted_err"] = max(ctl["kv_promoted_err"], rel_err(xb[:r0], ref[:r0]))
            kept[i] = None

        arch.forward(params, model, tokens, precision="fp8", on_state=compare_ctl)
        out["control"] = ctl
    return out


def _gap(ref_logits: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """(best − logit of the served token) / std, per row."""
    best = ref_logits.max(-1).values
    got = ref_logits.gather(-1, served[:, None])[:, 0]
    return (best - got) / ref_logits.std(-1)


def decode_numbers(arch: ModuleType, params: Dict, model: Dict, samples: List[Dict], device,
                   control: bool = False) -> Dict[str, Dict[str, float]]:
    """``samples``: dicts with ``prompt``, ``fed`` (the tokens fed to the decode
    steps, the first the prefill's argmax), ``served`` (every served token:
    the prefill's argmax, then each decode step's) and ``logits`` (the decode
    steps' rows, (n, V) f32)."""
    out = {"program": {"decode_gap": math.inf, "decode_logit_err": math.inf}}
    if not samples:
        return out
    P, n = len(samples[0]["prompt"]), len(samples[0]["fed"])
    tokens = torch.tensor([s["prompt"] + s["fed"] for s in samples], dtype=torch.long, device=device)
    at = list(range(P - 1, P + n))  # the prefill's last position, then each fed token's
    ref = arch.forward(params, model, tokens, logits_at=at)  # (B, n + 1, V)
    std = ref.std(-1)
    gap, lerr = 0.0, 0.0
    for b, s in enumerate(samples):
        served = torch.tensor(s["served"], dtype=torch.long, device=device)
        if served.numel() != n + 1 or tuple(s["logits"].shape) != (n, ref.shape[-1]):
            return out
        gap = max(gap, float(_gap(ref[b], served).max()))
        lerr = max(lerr, float(((s["logits"].to(device) - ref[b, 1:]).abs().max(-1).values / std[b, 1:]).max()))
    out["program"] = {"decode_gap": gap, "decode_logit_err": lerr}
    if control:
        low = arch.forward(params, model, tokens, logits_at=at, precision="fp8")
        served = low.argmax(-1)
        out["control"] = {
            "decode_gap": float(max(_gap(ref[b], served[b]).max() for b in range(len(samples)))),
            "decode_logit_err": float(((low - ref).abs().max(-1).values / std).max()),
        }
    return out


def verdict(numbers: Dict[str, float], limits: Optional[Dict[str, float]]) -> bool:
    """Every number within its limit; no limits (a cell not yet calibrated),
    or a number without one, is not correct."""
    if not limits:
        return False
    return all(name in limits and numbers[name] <= limits[name] for name in numbers) and \
        all(name in numbers for name in limits)
