"""A scene of quads, each split into two triangles (corners 0-1-2 and 0-2-3),
flat-shaded, with one parallelogram light: the Cornell box's measured data."""
from __future__ import annotations

import numpy as np


def build(spec: dict) -> dict:
    verts, idx, tri_mat = [], [], []
    for q in spec["quads"]:
        base = len(verts)
        verts.extend(q["corners"])
        idx.append((base + 0, base + 1, base + 2))
        idx.append((base + 0, base + 2, base + 3))
        tri_mat.extend([q["material"], q["material"]])
    return dict(vertices=np.asarray(verts, np.float32),
                indices=np.asarray(idx, np.int32),
                normals=None,
                tri_mat=np.asarray(tri_mat, np.int32),
                materials=spec["materials"],
                light=spec["light"],
                miss_color=tuple(spec.get("miss_color", (0.0, 0.0, 0.0))))
