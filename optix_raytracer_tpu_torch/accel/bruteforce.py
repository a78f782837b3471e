"""Brute-force intersection queries over ray batches of any shape
(counterpart of `accel/bruteforce.py:138-181`).

A CUDA ray batch goes to kernels 1 and 2 (`pallas_bf`), a CPU batch to their
plain versions; `chunk_size` bounds the plain version's [chunk, M] planes.
`boxes`, the geometry's group boxes (`tri_groups.bf_group_boxes`, which the
scene builds once), lets the kernels cull the table by groups of
`tri_groups.FUSED_GROUP` triangles; the values are the same without.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.rays import Hits, Rays
from . import pallas_bf
from .geometry import TriangleGeometry


def _flatten(rays: Rays):
    batch_shape = tuple(rays.batch_shape)
    n = 1
    for s in batch_shape:
        n *= s
    return rays.reshape(n), batch_shape


def intersect_closest(geom: TriangleGeometry, rays: Rays, tri_mat=None,
                      chunk_size: Optional[int] = 65536,
                      boxes: Optional[torch.Tensor] = None) -> Hits:
    """Closest hit → `Hits` of the rays' batch shape (inst_id 0 on a hit)."""
    flat, batch_shape = _flatten(rays)
    if tri_mat is None:
        tri_mat = torch.zeros((geom.num_triangles,), dtype=torch.int32,
                              device=geom.tri_consts.device)
    out = pallas_bf.closest_hit(geom.tri_consts, tri_mat, flat,
                                chunk_size=chunk_size, boxes=boxes)
    hit = out["prim_id"] >= 0

    def shape(a):
        return a.reshape(batch_shape + a.shape[1:])

    return Hits(t=shape(out["t"]), prim_id=shape(out["prim_id"]),
                inst_id=shape(torch.where(hit, 0, -1).to(torch.int32)),
                mat_id=shape(out["mat_id"]), uv=shape(out["uv"]),
                normal=shape(out["normal"]))


def intersect_any(geom: TriangleGeometry, rays: Rays,
                  chunk_size: Optional[int] = 65536,
                  boxes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Occlusion (shadow rays) → bool of the rays' batch shape."""
    flat, batch_shape = _flatten(rays)
    occ = pallas_bf.any_hit(geom.tri_consts, flat, chunk_size=chunk_size,
                            boxes=boxes)
    return occ.reshape(batch_shape)
