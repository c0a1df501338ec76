"""Cells at test size for the CPU: the configured models cut to a test's
widths (their architecture module's ``TEST_SIZES``) under traffic of the
cells' shapes, small enough for a test run.  ``smoke`` is the program's
own smoke variant (``get_config(..., smoke=True)``); ``control`` is deeper
and wider, where the fp8 control's error grows as it does over a full
model's depth, so that the cells' limits can tell it apart."""

from __future__ import annotations

import copy
from typing import Dict, Optional

from kvbench import arch
from kvbench import cell as cellmod


def smoke_config(name: str, size: str = "smoke") -> Dict:
    conf = copy.deepcopy(cellmod.load_json(cellmod.HERE / "configs" / f"{name}.json"))
    widths = arch.of(conf).TEST_SIZES[size]
    if size == "smoke":
        conf["smoke"] = True
    else:
        conf["port_overrides"] = {**conf.get("port_overrides", {}), **widths}
    conf["model"] = {**conf["model"], **widths}
    return conf


def smoke_traffic(name: str, size: str = "smoke") -> Dict:
    tr = copy.deepcopy(cellmod.load_json(cellmod.HERE / "traffic" / f"{name}.json"))
    g = tr["generator"]["params"]
    if tr["runner"] == "engine_loop":
        g.update(doc_tokens=64, question_tokens=16)
        tr["tiers"] = {"device_blocks": min(tr["tiers"]["device_blocks"], 8),
                       "host_blocks": min(tr["tiers"]["host_blocks"], 8)}
        tr["warm_requests"] = 1
        tr["profile_requests"] = [1, 3]
    else:
        g.update(prompt_tokens=32, output_tokens=8 if size == "smoke" else 24)
        tr["profile_steps"] = [10, 13]  # in the second request, as the cell places them
    return tr


def smoke_cell(name: str, limits: Optional[Dict[str, float]] = None, size: str = "smoke") -> cellmod.Cell:
    """The cell ``name`` of BENCHMARK.json, at a test size (``SIZES``)."""
    real = cellmod.resolve(name)
    config, traffic = name.split(".", 1)
    return cellmod.Cell(name=name, chips=1, config=smoke_config(config, size), traffic=smoke_traffic(traffic, size),
                        limits=real.limits if limits is None else limits,
                        end_to_end=real.end_to_end, per_layer=real.per_layer, units=real.units)
