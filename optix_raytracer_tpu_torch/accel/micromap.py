"""Opacity micromaps and displaced micromeshes (counterpart of
`accel/micromap.py`), built on the host in numpy; `micro_index` runs on
the hits in torch.

An opacity micromap samples a triangle's cutout mask on a barycentric grid
of 4^level micro-triangles and classifies each as opaque, transparent or
unknown (the 4-state mode of `optixOpacityMicromapArrayBuild`): traversal
answers the certain states without evaluating the mask. A displaced
micromesh subdivides each triangle 4^level ways and pushes the
micro-vertices along interpolated directions, giving a plain, denser mesh.

The module is the reference's, kept whole in the port so that the port
imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

# micro-triangle states (OptixOpacityMicromapState)
TRANSPARENT = 0
OPAQUE = 1
UNKNOWN_TRANSPARENT = 2
UNKNOWN_OPAQUE = 3


def _micro_corners(level: int):
    """Micro-triangle corner barycentrics at subdivision `level`: [T, 3, 2]
    (u, v) per corner, T = 4^level, enumerated row-major with the upright
    micro-triangle of each column before its inverted twin, the order
    `micro_index` inverts."""
    n = 1 << level
    tris = []
    for row in range(n):
        for col in range(n - row):
            u0, v0 = col / n, row / n
            s = 1.0 / n
            tris.append(((u0, v0), (u0 + s, v0), (u0, v0 + s)))
            if col < n - row - 1:
                tris.append(((u0 + s, v0), (u0 + s, v0 + s), (u0, v0 + s)))
    return np.asarray(tris, np.float32)


def _sample_points(sub: int = 3):
    """Barycentric sample lattice inside one micro-triangle: the interior
    points of a sub x sub grid, so a sample never lands on a mask edge it
    shares with a neighbour → [K, 3] (w, u, v)."""
    pts = []
    for i in range(sub):
        for j in range(sub - i):
            a = (i + 1.0 / 3.0) / sub
            b = (j + 1.0 / 3.0) / sub
            pts.append((1.0 - a - b, a, b))
    return np.asarray(pts, np.float32)


def build_opacity_micromap(corner_uv, mask_fn, level: int = 3,
                           samples: int = 3):
    """Classify each triangle's micro-triangles against a cutout mask.

    corner_uv [M, 3, 2] per-corner texture coordinates; mask_fn(uv [K, 2])
    → bool [K], True for a hole. A micro-triangle is OPAQUE or TRANSPARENT
    only when all its samples(samples+1)/2 interior samples agree, else
    UNKNOWN_OPAQUE. → (micro_states [M, 4^level] uint8, tri_summary [M]
    uint8): a summary is OPAQUE or TRANSPARENT only where every
    micro-triangle is and agrees, else UNKNOWN_OPAQUE."""
    corner_uv = np.asarray(corner_uv, np.float32)
    micro = _micro_corners(level)                            # [T, 3, 2]
    w_pts = _sample_points(samples)                          # [K, 3]
    suv = np.einsum("kc,tcx->tkx", w_pts, micro)             # [T, K, 2]
    u = suv[..., 0]
    v = suv[..., 1]
    w = 1.0 - u - v
    uv = (w[None, ..., None] * corner_uv[:, None, None, 0]
          + u[None, ..., None] * corner_uv[:, None, None, 1]
          + v[None, ..., None] * corner_uv[:, None, None, 2])
    m, t, k = uv.shape[:3]
    holes = np.asarray(mask_fn(uv.reshape(-1, 2))).reshape(m, t, k)
    all_hole = holes.all(axis=2)
    any_hole = holes.any(axis=2)
    states = np.full((m, t), UNKNOWN_OPAQUE, np.uint8)
    states[all_hole] = TRANSPARENT
    states[~any_hole] = OPAQUE
    summary = np.full(m, UNKNOWN_OPAQUE, np.uint8)
    summary[(states == TRANSPARENT).all(axis=1)] = TRANSPARENT
    summary[(states == OPAQUE).all(axis=1)] = OPAQUE
    return states, summary


def micro_index(u, v, level: int):
    """The micro-triangle of a hit's barycentrics (u, v) [...] f32 → int64
    [...], `_micro_corners`'s enumeration inverted: row r holds 2(n - r) - 1
    entries, so it starts at r(2n - r); column c's upright micro-triangle is
    entry 2c, its inverted twin 2c + 1. As the reference: u and v clipped to
    [0, 1 - 1e-7] in f32 and scaled by n, floored, the row clamped to n - 1
    and the column to n - 1 - row; inverted where the fractional parts sum
    past 1, and never in a row's last column."""
    n = 1 << level
    fu = torch.clamp(u, 0.0, 1.0 - 1e-7) * n
    fv = torch.clamp(v, 0.0, 1.0 - 1e-7) * n
    col = torch.floor(fu).to(torch.int32)
    row = torch.minimum(torch.floor(fv).to(torch.int32),
                        torch.full_like(col, n - 1))
    col = torch.minimum(col, n - 1 - row)
    inverted = (((fu - col) + (fv - row)) > 1.0) & (col < n - 1 - row)
    return (row * (2 * n - row) + 2 * col + inverted.to(torch.int32)).long()


def checker_mask(scale: float):
    """The checker cutout as a mask_fn: a hole where floor(s u) + floor(s
    v) is even."""
    def fn(uv):
        fu = uv * scale
        return (np.floor(fu[:, 0]) + np.floor(fu[:, 1])) % 2.0 < 1.0
    return fn


def circle_mask(scale: float, radius: float = 0.25):
    """The circle cutout as a mask_fn: a hole within `radius` of a cell's
    centre."""
    def fn(uv):
        cell = uv * scale - np.floor(uv * scale) - 0.5
        return (cell ** 2).sum(axis=1) < radius * radius
    return fn


def displace_mesh(vertices, indices, displacement, directions=None,
                  level: int = 3):
    """Subdivide each triangle 4^level ways and displace its micro-vertices.

    displacement: callable(points [K, 3], bary [K, 3]) → [K] amounts, or a
    constant. directions: [V, 3] per-vertex directions (default: the
    area-weighted vertex normals). → (vertices [M L, 3] f32, indices
    [M 4^level, 3] int32), L = (n + 1)(n + 2) / 2 lattice points a base
    triangle, not shared across base triangles (corners and edges are
    evaluated alike on both sides, so the mesh stays closed)."""
    vertices = np.asarray(vertices, np.float32)
    indices = np.asarray(indices, np.int32)
    n = 1 << level

    if directions is None:
        directions = np.zeros_like(vertices)
        tri = vertices[indices]
        fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        for k in range(3):
            np.add.at(directions, indices[:, k], fn)
        norms = np.linalg.norm(directions, axis=1, keepdims=True)
        directions = directions / np.maximum(norms, 1e-20)

    bary = []
    for row in range(n + 1):
        for col in range(n + 1 - row):
            bary.append((col / n, row / n))
    bary = np.asarray(bary, np.float32)              # [L, 2]
    u = bary[:, 0]
    v = bary[:, 1]
    w = 1.0 - u - v
    lattice = np.stack([w, u, v], axis=1)            # [L, 3]

    def row_start(row):
        return row * (n + 1) - row * (row - 1) // 2

    faces = []
    for row in range(n):
        for col in range(n - row):
            a = row_start(row) + col
            b = a + 1
            c = row_start(row + 1) + col
            faces.append((a, b, c))
            if col < n - row - 1:
                faces.append((b, row_start(row + 1) + col + 1, c))
    faces = np.asarray(faces, np.int32)              # [F0, 3]

    m = indices.shape[0]
    tri_v = vertices[indices]                        # [M, 3, 3]
    tri_d = directions[indices]
    pts = np.einsum("lk,mkx->mlx", lattice, tri_v)   # [M, L, 3]
    dirs = np.einsum("lk,mkx->mlx", lattice, tri_d)

    if callable(displacement):
        amounts = displacement(pts.reshape(-1, 3),
                               np.tile(lattice, (m, 1))).reshape(m, -1)
    else:
        amounts = np.full(pts.shape[:2], float(displacement), np.float32)
    new_pts = pts + dirs * amounts[..., None]

    L = lattice.shape[0]
    new_vertices = new_pts.reshape(-1, 3).astype(np.float32)
    offsets = (np.arange(m, dtype=np.int32) * L)[:, None, None]
    new_indices = (faces[None] + offsets).reshape(-1, 3).astype(np.int32)
    return new_vertices, new_indices
