"""Two-level acceleration: instances over one shared triangle GAS
(counterpart of `accel/tlas.py:29-196`).

An instance table holds per-instance affine transforms (object → world and
its inverse), an sbt offset added to the material id of the instance's hits,
an instance id, and the static triangle range [lo, hi) of the shared
geometry that the instance references. A query loops over the instances:
it moves the rays into the instance's object space by the inverse (the
direction is not normalised, so object-space t is world t), tests the
instance's triangle range by brute force (kernels 1-2 on a contiguous slice
of `tri_consts` on CUDA, their plain versions on the CPU) and keeps the
per-ray minimum. The winner's object-space normal goes back to world by the
inverse-transpose row rule and is normalised.

The reference can give an instanced mesh past 512 triangles its own
object-space cluster table (`mesh_clusters`); the port does not, and
`scene.device_scene.make_device_scene` refuses such a scene (ROADMAP.md
Queue 1 item 7).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..core import transforms as xf
from ..core.rays import Hits, Rays
from ..core.vecmath import dot
from . import bruteforce as bf
from .geometry import TriangleGeometry


@dataclasses.dataclass
class InstanceTable:
    """Instances over one shared (concatenated) geometry."""
    transform: torch.Tensor       # [I, 3, 4] object → world
    inv_transform: torch.Tensor   # [I, 3, 4] world → object
    sbt_offset: torch.Tensor      # [I] int32
    instance_id: torch.Tensor     # [I] int32 (the user-visible id)
    prim_ranges: tuple = ()       # static (lo, hi) per instance
    row_ids: bool = True          # instance_id == row: shading may look up
    #                               an instance's transform by its hit id

    @property
    def num(self) -> int:
        return self.transform.shape[0]

    @classmethod
    def empty(cls, device) -> "InstanceTable":
        z = torch.zeros((0, 3, 4), dtype=torch.float32, device=device)
        i = torch.zeros((0,), dtype=torch.int32, device=device)
        return cls(transform=z, inv_transform=z.clone(), sbt_offset=i,
                   instance_id=i.clone(), prim_ranges=())


def make_instances(transforms: Sequence, device, sbt_offsets=None,
                   instance_ids=None, prim_ranges=None,
                   num_prims: Optional[int] = None) -> InstanceTable:
    """An instance table from [3, 4] or [4, 4] transforms. prim_ranges: the
    per-instance (lo, hi) triangle range of the shared geometry; without
    it, the whole geometry of `num_prims` triangles (or no ranges at all
    when num_prims is None too)."""
    mats = torch.as_tensor(np.stack([np.asarray(t, np.float32)[:3, :4]
                                     for t in transforms]), device=device)
    n = mats.shape[0]
    if prim_ranges is None:
        prim_ranges = ((0, num_prims),) * n if num_prims is not None else ()
    return InstanceTable(
        transform=mats, inv_transform=xf.inverse(mats),
        sbt_offset=torch.as_tensor(
            np.zeros(n) if sbt_offsets is None else np.asarray(sbt_offsets),
            dtype=torch.int32, device=device),
        instance_id=torch.as_tensor(
            np.arange(n) if instance_ids is None else np.asarray(instance_ids),
            dtype=torch.int32, device=device),
        prim_ranges=tuple((int(lo), int(hi)) for lo, hi in prim_ranges),
        row_ids=instance_ids is None)


def instance_ranges(instances: InstanceTable, num_triangles: int) -> tuple:
    """The static (lo, hi) range of each instance: the table's own, or the
    whole shared geometry of `num_triangles` for each instance of a table
    without ranges (pallas_pt.py:257-263)."""
    return (instances.prim_ranges
            or ((0, num_triangles),) * instances.num)


def slice_geometry(geom: TriangleGeometry, lo: int, hi: int):
    """The static triangle range [lo, hi) of the shared geometry, as views:
    one instance's GAS. Row slices of the row-major planes stay contiguous,
    so kernels 1-2 take `tri_consts[lo:hi]` as it is."""
    def cut(a):
        return None if a is None else a[lo:hi]

    return TriangleGeometry(
        tri_consts=geom.tri_consts[lo:hi], face_normal=geom.face_normal[lo:hi],
        valid=geom.valid[lo:hi], v0=cut(geom.v0), e1=cut(geom.e1),
        e2=cut(geom.e2), corner_normal=cut(geom.corner_normal),
        smooth=geom.smooth, corner_uv=cut(geom.corner_uv),
        tangent=cut(geom.tangent), uv_density=cut(geom.uv_density))


def unit_world_normal(inv, n):
    """An object-space normal n [..., 3] back to world through inv
    [..., 3, 4] (transforms.normal_to_world), divided by its length clamped
    at 1e-12 (accel/tlas.py:151-153); the fused kernel repeats it."""
    w = xf.normal_to_world(inv, n)
    return w / torch.clamp_min(torch.sqrt(dot(w, w)), 1e-12)[..., None]


def _object_rays(inv, rays: Rays, tmax) -> Rays:
    return Rays(origin=xf.apply_point(inv, rays.origin),
                direction=xf.apply_vector(inv, rays.direction),
                tmin=rays.tmin, tmax=tmax)


def intersect_instances(geom: TriangleGeometry, instances: InstanceTable,
                        rays: Rays, tri_mat=None,
                        chunk_size: Optional[int] = 65536) -> Hits:
    """Closest hit through the instances (flat rays [N]). Each instance's
    query gets the current best t as its tmax; a hit reports its global
    triangle id, the instance id and tri_mat + sbt_offset; a miss has
    prim / inst / mat -1 and t = tmax."""
    n = rays.tmin.shape[0]
    dev = rays.origin.device
    t = rays.tmax
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    inst = torch.full((n,), -1, dtype=torch.int32, device=dev)
    mat = torch.full((n,), -1, dtype=torch.int32, device=dev)
    uv = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    normal = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    ranges = instance_ranges(instances, geom.num_triangles)
    for i, (lo, hi) in enumerate(ranges):
        inv = instances.inv_transform[i]
        h = bf.intersect_closest(
            slice_geometry(geom, lo, hi), _object_rays(inv, rays, t),
            tri_mat=None if tri_mat is None else tri_mat[lo:hi],
            chunk_size=chunk_size)
        closer = h.valid & (h.t < t)
        t = torch.where(closer, h.t, t)
        prim = torch.where(closer, h.prim_id + lo, prim)
        inst = torch.where(closer, instances.instance_id[i], inst)
        mat = torch.where(closer, h.mat_id + instances.sbt_offset[i], mat)
        uv = torch.where(closer[:, None], h.uv, uv)
        normal = torch.where(closer[:, None],
                             unit_world_normal(inv, h.normal), normal)
    return Hits(t=t, prim_id=prim, inst_id=inst, mat_id=mat, uv=uv,
                normal=normal)


def intersect_instances_any(geom: TriangleGeometry,
                            instances: InstanceTable, rays: Rays,
                            chunk_size: Optional[int] = 65536):
    """Occlusion through the instances → bool [N]; a ray already occluded
    gets an empty window in the later instances."""
    occ = torch.zeros(rays.tmin.shape, dtype=torch.bool,
                      device=rays.origin.device)
    ranges = instance_ranges(instances, geom.num_triangles)
    for i, (lo, hi) in enumerate(ranges):
        obj = _object_rays(instances.inv_transform[i], rays,
                           torch.where(occ, 0.0, rays.tmax))
        occ = occ | bf.intersect_any(slice_geometry(geom, lo, hi), obj,
                                     chunk_size=chunk_size)
    return occ
