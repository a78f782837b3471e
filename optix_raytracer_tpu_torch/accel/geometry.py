"""Triangle geometry, the unit-triangle (Woop) constants and the hit's
shading frame (counterpart of `accel/geometry.py:68-210`).

In triangle t's local frame a point is v0 + u*e1 + v*e2 + w*n, so the hit
test is t = -O'w/D'w, u = O'u + t*D'u, v = O'v + t*D'v with O' = M^-1 (O - v0)
and D' = M^-1 D. `tri_consts` row t packs M^-1 (rows u, v, w), the offsets
-M^-1 v0, the unit face normal and one spare column (the fused kernel puts
the material id there). Degenerate triangles get zeroed constants, so every
ray sees D'w = 0 and the strict |D'w| > eps test rejects them.

`v0`, `e1`, `e2` stay on the geometry for the cluster AABBs and the SAH
build; `corner_normal` holds per-corner shading normals (the face normal
three times unless `normals` are given, and then `smooth` is True);
`corner_uv` the per-corner texture coordinates (zero unless `uvs` are
given), `tangent` the uv-aligned unit tangent of normal mapping and
`uv_density` sqrt(uv area / world area), which turns the ray cone's
world-space width into texels for mip selection. `shading_frame`
interpolates them at a hit.
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
    corner_uv: Optional[torch.Tensor] = None      # [M, 3, 2]
    tangent: Optional[torch.Tensor] = None        # [M, 3]
    uv_density: Optional[torch.Tensor] = None     # [M]

    @property
    def num_triangles(self) -> int:
        return self.tri_consts.shape[0]


def build_triangle_geometry(vertices, indices, device, normals=None,
                            uvs=None) -> TriangleGeometry:
    """normals / uvs: optional per-vertex [V, 3] shading normals and [V, 2]
    texture coordinates."""
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
    if uvs is not None:
        uvs = torch.as_tensor(uvs, dtype=torch.float32, device=device)
        corner_uv = uvs[indices]                             # [M, 3, 2]
    else:
        corner_uv = torch.zeros((M, 3, 2), dtype=torch.float32, device=device)
    tangent, uv_density = uv_frame(corner_uv, e1, e2, dot(n, n))
    return TriangleGeometry(tri_consts=tri_consts.contiguous(),
                            face_normal=face_normal, valid=valid, v0=v0,
                            e1=e1, e2=e2, corner_normal=corner_normal,
                            smooth=normals is not None, corner_uv=corner_uv,
                            tangent=tangent, uv_density=uv_density)


def select_geometry(geom: TriangleGeometry, rows) -> TriangleGeometry:
    """The triangles `rows` ([R] int64 indices or [M] bool) of a geometry,
    each row as the geometry holds it: a build is row by row, so this
    equals building the selected triangles on their own (the opacity
    micromaps' solid and unknown splits, device_scene.py:412-470)."""
    def pick(a):
        return None if a is None else a[rows]

    return TriangleGeometry(
        tri_consts=geom.tri_consts[rows].contiguous(),
        face_normal=geom.face_normal[rows], valid=geom.valid[rows],
        v0=pick(geom.v0), e1=pick(geom.e1), e2=pick(geom.e2),
        corner_normal=pick(geom.corner_normal), smooth=geom.smooth,
        corner_uv=pick(geom.corner_uv), tangent=pick(geom.tangent),
        uv_density=pick(geom.uv_density))


def uv_frame(corner_uv, e1, e2, n_len2):
    """The uv-aligned unit tangent [M, 3] and the uv density [M] of each
    triangle (accel/geometry.py:131-142): the tangent solves the uv
    parametrisation for d(position)/du, e1 where the uv determinant is under
    1e-12 in magnitude; the density is sqrt(|det| / (2 x world area)), the
    doubled area clamped at 1e-12."""
    duv1 = corner_uv[:, 1] - corner_uv[:, 0]
    duv2 = corner_uv[:, 2] - corner_uv[:, 0]
    det = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    flat = torch.abs(det) < 1e-12
    safe_det = torch.where(flat, 1.0, det)
    raw = (duv2[:, 1:2] * e1 - duv1[:, 1:2] * e2) / safe_det[:, None]
    tangent = normalize(torch.where(flat[:, None], e1, raw))
    world_area2 = torch.sqrt(torch.clamp_min(n_len2, 1e-24))
    return tangent, torch.sqrt(torch.abs(det) / world_area2)


# Columns of the shade plane: v0, e1, e2, face normal, corner normals n0-n2,
# corner uvs uv0-uv2, tangent, uv density.
_PLANE = dict(v0=slice(0, 3), e1=slice(3, 6), e2=slice(6, 9),
              normal=slice(9, 12), n0=slice(12, 15), n1=slice(15, 18),
              n2=slice(18, 21), uv0=slice(21, 23), uv1=slice(23, 25),
              uv2=slice(25, 27), tangent=slice(27, 30),
              uv_density=slice(30, 31))


def shade_plane(geom: TriangleGeometry) -> torch.Tensor:
    """Per-triangle shading attributes in one [M, 31] plane, so a hit's
    frame is one row gather (accel/geometry.py:153-173, without its padding
    to 128 columns)."""
    m = geom.num_triangles
    return torch.cat([geom.v0, geom.e1, geom.e2, geom.face_normal,
                      geom.corner_normal.reshape(m, 9),
                      geom.corner_uv.reshape(m, 6), geom.tangent,
                      geom.uv_density[:, None]], dim=1)


def shading_frame(geom: TriangleGeometry, prim_id, uv, plane=None):
    """Hit-point attributes for shading (accel/geometry.py:176-210): the
    position v0 + u e1 + v e2, the face normal and the shading normal
    w n0 + u n1 + v n2 (w = 1 - u - v) divided by its length, or the face
    normal where that length is 1e-6 or less (zero corner normals of a mesh
    that shipped none, or normals that cancel); the texture coordinate
    w uv0 + u uv1 + v uv2, the tangent and the uv density. prim_id [...]
    (>= 0), uv [..., 2] barycentrics → dict of [..., 3] tensors, "uv"
    [..., 2] and "uv_density" [...].

    The fused kernel's smooth variant repeats this arithmetic in this order
    (the XLA engine's form; the Pallas kernel's delta form n0 + u (n1 - n0)
    + v (n2 - n0) with an rsqrt rounds apart, ROADMAP.md Queue 3)."""
    if plane is None:
        plane = shade_plane(geom)
    row = plane[torch.clamp_min(prim_id, 0).long()]
    col = {k: row[..., s] for k, s in _PLANE.items()}
    u, v = uv[..., 0:1], uv[..., 1:2]
    w = (1.0 - u) - v
    pos = (col["v0"] + u * col["e1"]) + v * col["e2"]
    sn = (w * col["n0"] + u * col["n1"]) + v * col["n2"]
    sn_len = torch.sqrt(dot(sn, sn))[..., None]
    sn = torch.where(sn_len > 1e-6, sn / torch.clamp_min(sn_len, 1e-12),
                     col["normal"])
    tex_uv = (w * col["uv0"] + u * col["uv1"]) + v * col["uv2"]
    return {"position": pos, "normal": col["normal"], "shading_normal": sn,
            "uv": tex_uv, "tangent": col["tangent"],
            "uv_density": col["uv_density"][..., 0]}
