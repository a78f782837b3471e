"""Triangle groups: the widened boxes of consecutive triangles that the
brute-force kernels (1 and 2, `accel/pallas_bf.py`) and the fused
path-trace kernel (3 / 3', `wavefront/pallas_pt.py`) cull a triangle table
with, and the group test in plain PyTorch.

A table of at least FUSED_CULL_MIN_TRIS triangles is cut into groups of
FUSED_GROUP consecutive triangles; a smaller table is tested whole, without
a box. A ray tests a group's triangles only when its slab test crosses the
group's box widened by the walks' admission margin. Groups go in ascending
order, a group's triangles too, and a closest-hit loop passes its running
best t as the slab's tmax, so with the strict t < best t the lowest index
still wins a tie and the culled loops give brute force's ids bit for bit
(`pallas_bf._group_walk`).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import clusters as cluster_mod

# From the fused kernel's cutoff table (tools/bench_fused.py on the H100,
# PERF.md §6): culling paid on every table measured from 10 triangles up
# (knots of 10-482, the Cornell scenes' 32, textured grids of 16-256), and
# groups of 8 were within 13% of the best size (4, 8 or 16) on every one.
FUSED_CULL_MIN_TRIS = 10
FUSED_GROUP = 8
# Columns of a group box row: lo xyz, hi xyz, two pad (32-byte rows).
BOX_COLS = 8


def fused_group_boxes(geom, group: int) -> torch.Tensor:
    """The kernels' group boxes: triangles [g * group, (g + 1) * group) of
    `geom` → [ceil(M / group), BOX_COLS] f32 rows (lo xyz, hi xyz, 0, 0),
    the box of the group's vertices v0, v0 + e1, v0 + e2 widened on every
    side by the walks' admission margin, extent * 2^-6 + magnitude * 2^-14
    (accel/clusters.py sc_widened_boxes). A hit the Woop test accepts lies
    within a few ulps of its triangle, and the slab test errs by a few ulps
    of the distance along the ray; the margin covers both (the cluster
    walks' dropped-pair audits hold it on the card, tests/
    test_torch_fused_groups.py here)."""
    m = geom.num_triangles
    n = -(-m // group)
    verts = torch.stack([geom.v0, geom.v0 + geom.e1, geom.v0 + geom.e2],
                        dim=1)                                  # [M, 3, 3]
    pad = n * group - m
    lo = torch.cat([verts.amin(dim=1),
                    verts[-1:].amin(dim=1).expand(pad, 3)])
    hi = torch.cat([verts.amax(dim=1),
                    verts[-1:].amax(dim=1).expand(pad, 3)])
    box = torch.cat([lo.reshape(n, group, 3).amin(dim=1),
                     hi.reshape(n, group, 3).amax(dim=1)], dim=1)  # [n, 6]
    wlo, whi, _ = cluster_mod.sc_widened_boxes(box.T[None])
    out = torch.zeros((n, BOX_COLS), dtype=torch.float32, device=box.device)
    out[:, 0:3] = wlo[0].T
    out[:, 3:6] = whi[0].T
    return out


def fused_group_admitted_plain(o, d, tmin, tmax, boxes) -> torch.Tensor:
    """The kernels' group test in plain PyTorch: rays o, d [N, 3], tmin,
    tmax [N] against group boxes [G, BOX_COLS] → bool [N, G], set where the
    ray is live and its slab test (clusters._slab_cross, the exact cull's:
    the +-1e12 pseudo-inverse, max(tn, tmin) <= min(tf, tmax)) crosses the
    box. The closest loop passes the ray's running best t as tmax."""
    a = torch.cat([o, d, tmin[:, None], tmax[:, None]], dim=1)[None]
    return cluster_mod._slab_cross(a, boxes[None, :, 0:3].transpose(1, 2),
                                   boxes[None, :, 3:6].transpose(1, 2))[0][0]


def bf_group_boxes(geom) -> Optional[torch.Tensor]:
    """Kernels 1-2's group boxes of a triangle table (a whole geometry or
    an instance's slice): fused_group_boxes at FUSED_GROUP from
    FUSED_CULL_MIN_TRIS triangles on, else None (the table is tested
    whole)."""
    if geom.num_triangles < FUSED_CULL_MIN_TRIS or geom.v0 is None:
        return None
    return fused_group_boxes(geom, FUSED_GROUP)
