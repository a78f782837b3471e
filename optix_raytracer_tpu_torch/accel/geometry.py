"""Triangle geometry and the unit-triangle (Woop) constants (counterpart of
`accel/geometry.py:68-150`).

In triangle t's local frame a point is v0 + u*e1 + v*e2 + w*n, so the hit
test is t = -O'w/D'w, u = O'u + t*D'u, v = O'v + t*D'v with O' = M^-1 (O - v0)
and D' = M^-1 D. `tri_consts` row t packs M^-1 (rows u, v, w), the offsets
-M^-1 v0, the unit face normal and one spare column (the fused kernel puts
the material id there). Degenerate triangles get zeroed constants, so every
ray sees D'w = 0 and the strict |D'w| > eps test rejects them.

`v0`, `e1`, `e2` stay on the geometry for the cluster AABBs and the SAH
build; `corner_normal` holds per-corner shading normals (the face normal
three times unless `normals` are given, and then `smooth` is True).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.vecmath import cross, dot, normalize


@dataclasses.dataclass
class TriangleGeometry:
    tri_consts: torch.Tensor    # [M, 16] float32
    face_normal: torch.Tensor   # [M, 3] unit geometric normals
    valid: torch.Tensor         # [M] bool, False for degenerate triangles
    v0: Optional[torch.Tensor] = None            # [M, 3]
    e1: Optional[torch.Tensor] = None            # [M, 3] v1 - v0
    e2: Optional[torch.Tensor] = None            # [M, 3] v2 - v0
    corner_normal: Optional[torch.Tensor] = None  # [M, 3, 3]
    smooth: bool = False

    @property
    def num_triangles(self) -> int:
        return self.tri_consts.shape[0]


def build_triangle_geometry(vertices, indices, device,
                            normals=None) -> TriangleGeometry:
    """normals: optional per-vertex [V, 3] shading normals."""
    vertices = torch.as_tensor(vertices, dtype=torch.float32, device=device)
    indices = torch.as_tensor(indices, dtype=torch.int64, device=device)
    v0 = vertices[indices[:, 0]]
    e1 = vertices[indices[:, 1]] - v0
    e2 = vertices[indices[:, 2]] - v0
    n = cross(e1, e2)
    valid = dot(n, n) > 1e-24

    # Rows of M^-1 for M = [e1 | e2 | n] are the cofactor columns / det.
    c0 = cross(e2, n)
    c1 = cross(n, e1)
    c2 = cross(e1, e2)
    det = dot(e1, c0)
    inv_det = torch.where(valid, 1.0 / torch.where(valid, det, 1.0), 0.0)
    m_inv = torch.stack([c0, c1, c2], dim=1) * inv_det[:, None, None]
    m_inv = m_inv * valid[:, None, None]

    M = indices.shape[0]
    offsets = -(m_inv[:, :, 0] * v0[:, None, 0] + m_inv[:, :, 1] * v0[:, None, 1]
                + m_inv[:, :, 2] * v0[:, None, 2])
    face_normal = normalize(n)
    tri_consts = torch.cat([m_inv.reshape(M, 9), offsets, face_normal,
                            torch.zeros((M, 1), dtype=torch.float32,
                                        device=device)], dim=1)
    if normals is not None:
        normals = torch.as_tensor(normals, dtype=torch.float32, device=device)
        corner_normal = normals[indices]                     # [M, 3, 3]
    else:
        corner_normal = face_normal[:, None, :].expand(M, 3, 3)
    return TriangleGeometry(tri_consts=tri_consts.contiguous(),
                            face_normal=face_normal, valid=valid, v0=v0,
                            e1=e1, e2=e2, corner_normal=corner_normal,
                            smooth=normals is not None)
