"""The SPD `tetra` (E. Haines, "A Proposal for Standard Graphics
Environments", IEEE CG&A 7(11), 1987): a regular tetrahedron of edge `edge`,
y up, its base on y = 0 centred on the y axis, replaced `level` times by the
four half-size tetrahedra at its corners (p → (p + corner) / 2, in float64),
4^(level + 1) flat triangles, material `tetra_material`; then the lamp, a
quad of two triangles (material `lamp_material`) where the parallelogram
light lies, and the light."""
from __future__ import annotations

import math

import numpy as np

# A tetrahedron's four faces by corner, wound outward.
FACES = np.array([[1, 3, 2], [0, 2, 3], [0, 3, 1], [0, 1, 2]], np.int32)


def corners(edge: float) -> np.ndarray:
    """The level-0 corners [4, 3] (float64): three on y = 0 about the y axis
    (the back one on +z), the apex above."""
    r = edge / math.sqrt(3.0)
    h = edge * math.sqrt(2.0 / 3.0)
    return np.array([[0.0, 0.0, r], [-0.5 * edge, 0.0, -0.5 * r],
                     [0.5 * edge, 0.0, -0.5 * r], [0.0, h, 0.0]], np.float64)


def build(spec: dict) -> dict:
    c = corners(spec["edge"])
    tets = c[None]
    for _ in range(spec["level"]):
        tets = ((tets[None] + c[:, None, None]) * 0.5).reshape(-1, 4, 3)
    n = tets.shape[0]
    verts = tets.reshape(-1, 3).astype(np.float32)
    idx = (np.arange(n, dtype=np.int32)[:, None, None] * 4
           + FACES[None]).reshape(-1, 3)
    light = spec["light"]
    o, v1, v2 = (np.asarray(light[k], np.float64) for k in ("corner", "v1",
                                                            "v2"))
    lamp = np.stack([o, o + v1, o + v1 + v2, o + v2]).astype(np.float32)
    n0 = len(verts)
    verts = np.concatenate([verts, lamp])
    idx = np.concatenate([idx, np.array([[n0, n0 + 1, n0 + 2],
                                         [n0, n0 + 2, n0 + 3]], np.int32)])
    tri_mat = np.concatenate([np.full(4 * n, spec["tetra_material"], np.int32),
                              np.full(2, spec["lamp_material"], np.int32)])
    return dict(vertices=verts, indices=idx, normals=None, tri_mat=tri_mat,
                materials=spec["materials"], light=light,
                miss_color=tuple(spec.get("miss_color", (0.0, 0.0, 0.0))))
