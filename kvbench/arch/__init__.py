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
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Dict

DEFAULT = "dense_gqa"


def of(config: Dict) -> ModuleType:
    """The architecture module the configuration file names."""
    return importlib.import_module(f"{__name__}.{config.get('arch', DEFAULT)}")
