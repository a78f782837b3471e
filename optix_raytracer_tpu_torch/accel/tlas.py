"""Two-level acceleration: instances over one shared triangle GAS
(counterpart of `accel/tlas.py:29-196`).

An instance table holds per-instance affine transforms (object → world and
its inverse), an sbt offset added to the material id of the instance's hits,
an instance id, and the static triangle range [lo, hi) of the shared
geometry that the instance references. A query loops over the instances:
it moves the rays into the instance's object space by the inverse (the
direction is not normalised, so object-space t is world t), tests the
instance's triangle range by brute force (kernels 1-2 on a contiguous slice
of `tri_consts` on CUDA, culled by the slice's own group boxes where it is
given them, their plain versions on the CPU) and keeps the per-ray
minimum. The winner's object-space normal goes back to world by the
inverse-transpose row rule and is normalised.

An instance whose range has its own object-space cluster table
(`mesh_clusters`, `scene/device_scene.py::_build_instance_clusters`; the
reference's `tlas.py:109-196`) walks it instead: kernels 4 + 5 for the
closest hit, 4 + 6 for occlusion, on its object-space rays (their plain
versions on the CPU).
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
from . import clusters as cluster_mod
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


def world_shading_normal(instances: InstanceTable, hits: Hits, is_tri, sn):
    """An instanced scene's interpolated normal `sn` (the shading frame's,
    in the hit instance's object space) back to world by the instance's
    inverse (unit_world_normal) where a triangle was hit; with ids that are
    not rows of the table, or off the triangles, the hit's geometric
    normal."""
    if not instances.row_ids:
        return hits.normal
    inv = instances.inv_transform[torch.clamp_min(hits.inst_id, 0).long()]
    return torch.where((is_tri & (hits.inst_id >= 0))[..., None],
                       unit_world_normal(inv, sn), hits.normal)


def _object_rays(inv, rays: Rays, tmax) -> Rays:
    return Rays(origin=xf.apply_point(inv, rays.origin),
                direction=xf.apply_vector(inv, rays.direction),
                tmin=rays.tmin, tmax=tmax)


def _closest_in(geom, lo, hi, obj_rays, tri_mat, chunk_size, boxes,
                mesh_clusters, exact):
    """One instance's closest hit on its object-space rays, with
    slice-local triangle ids: its cluster table where it has one, else
    brute force on its slice."""
    if mesh_clusters and (lo, hi) in mesh_clusters:
        return cluster_mod.closest_hit(mesh_clusters[(lo, hi)], obj_rays,
                                       exact=exact)
    return bf.intersect_closest(
        slice_geometry(geom, lo, hi), obj_rays,
        tri_mat=None if tri_mat is None else tri_mat[lo:hi],
        chunk_size=chunk_size, boxes=boxes)


def intersect_instances(geom: TriangleGeometry, instances: InstanceTable,
                        rays: Rays, tri_mat=None,
                        chunk_size: Optional[int] = 65536,
                        boxes: Optional[Sequence] = None,
                        mesh_clusters: Optional[dict] = None,
                        exact: bool = False) -> Hits:
    """Closest hit through the instances (flat rays [N]). Each instance's
    query gets the current best t as its tmax; a hit reports its global
    triangle id, the instance id and tri_mat + sbt_offset; a miss has
    prim / inst / mat -1 and t = tmax. boxes: per instance its slice's
    group boxes or None (`DeviceScene.bf_boxes`). mesh_clusters:
    {(lo, hi): ClusterSet}, the object-space cluster tables of the ranges
    that have one (`DeviceScene.instance_clusters`); exact: their walks
    take the exact cull (kernel 4), as the scene's table does for scattered
    wavefronts. The cull changes the work, never a hit."""
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
        h = _closest_in(geom, lo, hi, _object_rays(inv, rays, t), tri_mat,
                        chunk_size, None if boxes is None else boxes[i],
                        mesh_clusters, exact)
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
                            chunk_size: Optional[int] = 65536,
                            boxes: Optional[Sequence] = None,
                            mesh_clusters: Optional[dict] = None):
    """Occlusion through the instances → bool [N]; a ray already occluded
    gets an empty window in the later instances (on a cluster table, the
    walks then skip its blocks). boxes and mesh_clusters as
    intersect_instances; a table's walk takes the exact cull (kernels 4 +
    6), as the scene's occlusion queries do (mixed liveness)."""
    occ = torch.zeros(rays.tmin.shape, dtype=torch.bool,
                      device=rays.origin.device)
    ranges = instance_ranges(instances, geom.num_triangles)
    for i, (lo, hi) in enumerate(ranges):
        obj = _object_rays(instances.inv_transform[i], rays,
                           torch.where(occ, 0.0, rays.tmax))
        if mesh_clusters and (lo, hi) in mesh_clusters:
            occ = occ | cluster_mod.any_hit(mesh_clusters[(lo, hi)], obj,
                                            exact=True)
        else:
            occ = occ | bf.intersect_any(
                slice_geometry(geom, lo, hi), obj, chunk_size=chunk_size,
                boxes=None if boxes is None else boxes[i])
    return occ
