"""One module per architecture the harness can hold the program against:
``kvbench/arch/<arch>.py``, chosen by the configuration file's optional
``"arch"`` key (absent: ``dense_gqa``).  Everything model-specific that
the harness needs sits there, so that a new architecture arrives as new
files.  A module provides:

``check_config(cfg, config)``
    raises unless the program's ModelConfig ``cfg`` runs what the
    configuration file ``config`` states, as this module's reference does.
``shapes(model)``, ``init(leaf_name, shape)``
    the weight tree's shapes for the file's ``model`` object, and how a
    leaf is drawn: ``("fill", value)`` or ``("normal", std)``
    (``kvbench/weights.py`` draws them).
``forward(params, model, tokens, *, logits_at=None, precision="f32", on_state=None)``
    the plain reference; ``on_state(layer, {part: (B, S, ...) f32})`` gets
    the state the program stores for each layer; returns the logits at
    ``logits_at`` or None.  ``precision="fp8"`` is the control.
``unpack_blocks(blocks, model, device)``
    stored blocks to ``{part: (L, tokens, ...)}`` f32, or None where a
    block is missing or misshapen.
``block_bytes(model, block)``
    the bytes of one stored block as the program commits it.
``prefill_flops(model, S)``, ``flash_call(model, S)``, ``decode_step(model, kv_len)``, ``paged_decode_call(model, kv_len)``
    the operations (and bytes) of the steps and kernels the cells run.
``KERNELS``
    the port's kernels a run builds before its set-up.
``TEST_SIZES``
    ``{"smoke": ..., "control": ...}``: the ``model`` keys a CPU test
    sets, ``smoke`` the program's own smoke variant, ``control`` deep
    enough for the fp8 control's error to build up as over a full model.

A module whose model routes tokens to experts also provides:

``ROUTED = True``
    (absent: False).  ``check.kv_numbers`` then holds the stored state
    against the reference under the program's own expert choices, and
    judges those choices apart (``route_gap``).
``forward(..., route=None, on_route=None)``
    ``route`` is ``{layer: (B, S, k) long}``: where it is given, each MoE
    layer takes those experts in place of its own top-k, with the gate
    weights still the reference's own f32 scores at those ids, normalised
    and scaled as the model says (``chosen`` below picks them, and refuses
    a route that holds no valid choice for the layer).  ``on_route(layer,
    ids, scores)`` gets the ids the layer used and its selection scores
    ``(B, S, E)`` f32 (with the correction bias, where the model has one).
    Under ``precision="fp8"`` without ``route`` the control routes itself,
    and ``on_route`` reports its own choice.

The program provides the routes through its prefill hook: where the hook
has an attribute ``route``, ``{layer: (S, k) int}`` on the device for the
positions its last call computed, ``runners/engine_loop.py`` keeps it
beside that call's blocks.
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Dict, Optional

import torch

DEFAULT = "dense_gqa"


def of(config: Dict) -> ModuleType:
    """The architecture module the configuration file names."""
    return importlib.import_module(f"{__name__}.{config.get('arch', DEFAULT)}")


def chosen(select: torch.Tensor, k: int, route: Optional[Dict], layer: int) -> torch.Tensor:
    """The experts a routed layer takes, (B, S, k) long: the top ``k`` of
    its selection scores ``select`` (B, S, E), or ``route[layer]`` where a
    route is given.  A given route without the layer, of another shape, or
    with an id outside [0, E) or repeated within a token raises ValueError."""
    if route is None:
        return select.topk(k, dim=-1).indices
    ids = route.get(layer)
    want = (*select.shape[:-1], k)
    if ids is None or tuple(ids.shape) != want:
        raise ValueError(f"layer {layer}: the route holds {None if ids is None else tuple(ids.shape)}, "
                         f"the layer takes {want}")
    ids = ids.to(select.device, torch.long)
    if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= select.shape[-1]
                        or bool((ids.sort(-1).values.diff(dim=-1) == 0).any())):
        raise ValueError(f"layer {layer}: the route's ids leave [0, {select.shape[-1]}) or repeat within a token")
    return ids
