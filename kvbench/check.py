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
reads ``inf``.  Where the architecture module routes tokens to experts
(``ROUTED``), a token whose k-th and (k+1)-th router scores lie within the
program's rounding may take another expert in the program than in the
reference, and from then on its state differs by far more than rounding.
So the f32 reference runs under the program's own expert choices (the
sample's ``route``, kept by the runner), the two numbers above are read
against that run, and the choices are judged apart:

  route_gap        (best score of an unchosen expert − worst score of a
                   chosen one)⁺ / std of the token's selection scores, the
                   reference's in that run, the largest over the sampled
                   tokens and MoE layers: what ``decode_gap`` is to a
                   served token

A routed sample without a route, or with one the reference refuses, reads
``inf`` in all three.  The control records its own routes in its fp8 run,
and is judged against the f32 reference run under those: each side under
its own routing.  Over every request of the window, not only the sample,
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


KV = ("kv_fresh_err", "kv_promoted_err")
ROUTED_KV = KV + ("route_gap",)


def kv_numbers(arch: ModuleType, params: Dict, model: Dict, samples: List[Dict], block: int, device,
               control: bool = False) -> Dict[str, Dict[str, float]]:
    """``samples``: dicts with ``tokens`` (the prompt), ``reused`` (tokens the
    program took from the cache), ``fresh`` (the hook's blocks),
    ``promoted`` (the cache's blocks of the reused prefix) and, from a
    program that routes, ``route`` ({layer: (S, k) ids}).  Returns
    {"program": numbers} and, with ``control``, {"control": numbers} of the
    reference in fp8 put in the program's place."""
    routed = bool(getattr(arch, "ROUTED", False))
    if not samples:
        return {"program": dict.fromkeys(ROUTED_KV if routed else KV, math.inf)}
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
    if routed:
        return _routed_numbers(arch, params, model, tokens, progs, _routes(samples, device), control)
    out = {"program": dict.fromkeys(KV, 0.0)}
    num = out["program"]
    kept: List = [None] * model["n_layers"] if control else None

    def compare(i, parts):
        _program_err(num, progs, i, parts)
        if kept is not None:
            kept[i] = {name: x.clone() for name, x in parts.items()}

    arch.forward(params, model, tokens, on_state=compare)
    if control:
        ctl = dict.fromkeys(KV, 0.0)

        def compare_ctl(i, parts):
            _control_err(ctl, progs, parts, kept[i])
            kept[i] = None

        arch.forward(params, model, tokens, precision="fp8", on_state=compare_ctl)
        out["control"] = ctl
    return out


def _program_err(num: Dict, progs: List, i: int, parts: Dict) -> None:
    """Layer ``i`` of the program's blocks against the reference's ``parts``."""
    for b, (r0, r1, fresh, prom) in enumerate(progs):
        for name, x in parts.items():
            ref = x[b]
            num["kv_fresh_err"] = max(num["kv_fresh_err"], math.inf if fresh is None
                                      else rel_err(fresh[name][i], ref[r0:r1]))
            num["kv_promoted_err"] = max(num["kv_promoted_err"], math.inf if prom is None
                                         else rel_err(prom[name][i], ref[:r0]))


def _control_err(num: Dict, progs: List, low: Dict, refs: Dict) -> None:
    """One layer of the control's state ``low`` against the reference's ``refs``."""
    for b, (r0, r1, _, _) in enumerate(progs):
        for name, x in low.items():
            xb, ref = x[b], refs[name][b]
            num["kv_fresh_err"] = max(num["kv_fresh_err"], rel_err(xb[r0:r1], ref[r0:r1]))
            num["kv_promoted_err"] = max(num["kv_promoted_err"], rel_err(xb[:r0], ref[:r0]))


def _routes(samples: List[Dict], device) -> Optional[Dict[int, torch.Tensor]]:
    """The sample's routes stacked, {layer: (B, S, k) long}, or None where a
    request has none, or the requests' layers or shapes disagree (the
    reference refuses a shape other than its own)."""
    routes = [s.get("route") for s in samples]
    if any(r is None for r in routes) or any(set(r) != set(routes[0]) for r in routes):
        return None
    out = {}
    for i in routes[0]:
        ids = [torch.as_tensor(r[i]) for r in routes]
        if any(x.shape != ids[0].shape for x in ids):
            return None
        out[i] = torch.stack(ids).to(device, torch.long)
    return out


def route_gap(ids: torch.Tensor, scores: torch.Tensor) -> float:
    """The largest, over tokens, of (best unchosen − worst chosen score)⁺ /
    std of the token's scores.  ``ids`` (..., k), ``scores`` (..., E)."""
    chosen = torch.zeros_like(scores, dtype=torch.bool).scatter_(-1, ids, True)
    worst = scores.masked_fill(~chosen, math.inf).amin(-1)
    best = scores.masked_fill(chosen, -math.inf).amax(-1)
    return float(((best - worst).clamp_min(0) / scores.std(-1).clamp_min(1e-30)).max())


def _routed_numbers(arch: ModuleType, params: Dict, model: Dict, tokens: torch.Tensor, progs: List,
                    route: Optional[Dict], control: bool) -> Dict[str, Dict[str, float]]:
    """Each side's numbers against the f32 reference run under its own routes."""

    def judged(route, compare) -> Dict[str, float]:
        num = dict.fromkeys(ROUTED_KV, 0.0)
        if route is None:
            return dict.fromkeys(num, math.inf)
        seen = set()

        def on_route(i, ids, scores):
            seen.add(i)
            num["route_gap"] = max(num["route_gap"], route_gap(route[i], scores))

        try:
            arch.forward(params, model, tokens, route=route, on_route=on_route,
                         on_state=lambda i, parts: compare(num, i, parts))
        except ValueError:  # the reference refuses the route: a layer missing, an id out of range or repeated
            return dict.fromkeys(num, math.inf)
        return num if seen == set(route) else dict.fromkeys(num, math.inf)

    out = {"program": judged(route, lambda num, i, parts: _program_err(num, progs, i, parts))}
    if control:
        kept, routes = {}, {}

        def keep(i, parts):
            kept[i] = {name: x.clone() for name, x in parts.items()}

        arch.forward(params, model, tokens, precision="fp8", on_state=keep,
                     on_route=lambda i, ids, scores: routes.__setitem__(i, ids.clone()))
        out["control"] = judged(routes, lambda num, i, parts: _control_err(num, progs, kept.pop(i), parts))
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
