"""The frozen lower bound of a launch's work, for `kernel_roofline_pct`.

Whatever implementation renders a launch, it must test each traced ray
against at least one triangle and one box, and write the film and read the
scene once. So its time is at least the larger of

    rays * (TRI_TEST_FLOPS + SLAB_FLOPS) / peak FP32 FLOP/s
    (film bytes + scene bytes) / peak HBM bytes/s

with the peaks of `peaks.json` for the card's name.
"""
from __future__ import annotations

import json
from pathlib import Path

TRI_TEST_FLOPS = 30
SLAB_FLOPS = 20


def peaks(kind: str):
    table = json.loads((Path(__file__).parent / "peaks.json").read_text())
    return table.get(kind)


def scene_bytes(arrays: dict) -> int:
    """The scene's tables as handed to the program: vertices, indices,
    per-vertex normals and triangle materials."""
    return int(sum(arrays[k].nbytes for k in ("vertices", "indices", "normals",
                                              "tri_mat")
                   if arrays.get(k) is not None))


def bound_s(rays: float, width: int, height: int, scene_nbytes: int,
            peak: dict) -> float:
    flops = rays * (TRI_TEST_FLOPS + SLAB_FLOPS)
    nbytes = width * height * 3 * 4 + scene_nbytes
    return max(flops / peak["fp32_flops"], nbytes / peak["hbm_bytes_per_s"])
