"""The torch DeviceScene (counterpart of `scene/device_scene.py:32-175,
474-575`).

The port's scene holds triangle geometry (with per-corner shading normals),
per-triangle material ids, the material table, the custom-prim table
(kinds 0-3), the parallelogram area light, the miss color, the static
feature tags (glass, mirror, pbr, computed from the material dicts as the
reference does), the instance table of a two-level scene and, for a flat
mesh past the brute-force kernels' 512 triangles, the cluster table of the
large-mesh traversal. BVHs, per-mesh cluster tables of instanced meshes,
textures, cutouts, volumes and motion are not ported yet (ROADMAP.md Queue 1
items 6-9).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..accel import clusters as cluster_mod
from ..accel import native
from ..accel import primitives as prim_mod
from ..accel.geometry import TriangleGeometry, build_triangle_geometry
from ..accel.tlas import InstanceTable, instance_ranges
from ..shade.lights import ParallelogramLight
from ..shade.materials import GLASS, PBR, MaterialTable, make_material_table

# Feature tags of the JAX DeviceScene that the port does not render yet,
# with their ROADMAP.md Queue 1 item.
UNPORTED_FEATURES = {"cutouts": 8, "volume": 9}

# Meshes past the brute-force kernels' budget get a cluster table
# (accel/pallas_bf.py MAX_SMEM_TRIS, scene/device_scene.py:533-542).
MAX_SMEM_TRIS = 512


@dataclasses.dataclass
class DeviceScene:
    geom: TriangleGeometry
    tri_mat: torch.Tensor               # [M] int32 material id per triangle
    materials: MaterialTable
    area_light: ParallelogramLight      # NEE target
    miss_color: torch.Tensor            # [3] constant background
    features: tuple = ()
    clusters: Optional[cluster_mod.ClusterSet] = None
    prims: Optional[prim_mod.CustomPrims] = None
    instances: Optional[InstanceTable] = None

    def __post_init__(self):
        if self.prims is None:
            self.prims = prim_mod.CustomPrims.empty(self.device)
        if self.instances is None:
            self.instances = InstanceTable.empty(self.device)

    @property
    def num_triangles(self):
        return self.geom.num_triangles

    @property
    def has_clusters(self) -> bool:
        return self.clusters is not None and self.clusters.num_clusters > 0

    @property
    def has_instances(self) -> bool:
        return self.instances.num > 0

    @property
    def device(self):
        return self.geom.tri_consts.device

    @property
    def has_pbr(self) -> bool:
        """Rough metallic-roughness lanes: the bounce draws two more RNG
        pairs on every lane (engine.py:506-527)."""
        return "pbr" in self.features

    @property
    def has_specular(self) -> bool:
        return "glass" in self.features or "mirror" in self.features

    def require_supported(self):
        """Raise for the features the port does not render yet."""
        prim_mod.require_ported(self.prims)
        for f in self.features:
            if f in UNPORTED_FEATURES:
                raise NotImplementedError(
                    f"scene feature {f!r} is not ported yet (ROADMAP.md "
                    f"Queue 1 item {UNPORTED_FEATURES[f]})")


def _check_tri_mat(tri_mat, num_tris, num_mats):
    tri_mat = np.asarray(tri_mat, np.int32).reshape(-1)
    if tri_mat.shape[0] != num_tris:
        raise ValueError(f"tri_mat has {tri_mat.shape[0]} entries for "
                         f"{num_tris} triangles")
    if tri_mat.size and (tri_mat.min() < 0 or tri_mat.max() >= num_mats):
        raise ValueError(f"material ids must lie in [0, {num_mats})")
    return tri_mat


def _check_instances(instances: InstanceTable, tri_mat, num_tris, num_mats):
    """Each range inside the geometry and within the brute-force budget
    (the reference gives a larger instanced mesh its own cluster table,
    scene/device_scene.py:543-556, which is not ported), and each hit's
    material id, tri_mat + sbt_offset, inside the table."""
    sbt = instances.sbt_offset.cpu().numpy()
    for i, (lo, hi) in enumerate(instance_ranges(instances, num_tris)):
        if not 0 <= lo <= hi <= num_tris:
            raise ValueError(f"instance {i}: range ({lo}, {hi}) outside the "
                             f"{num_tris} triangles")
        if hi - lo > MAX_SMEM_TRIS:
            raise NotImplementedError(
                f"instance {i}: a mesh of {hi - lo} triangles needs a "
                f"per-mesh cluster table, which is not ported yet "
                f"(ROADMAP.md Queue 1 item 7)")
        ids = tri_mat[lo:hi] + sbt[i]
        if ids.size and (ids.min() < 0 or ids.max() >= num_mats):
            raise ValueError(f"instance {i}: material ids with its sbt "
                             f"offset must lie in [0, {num_mats})")


def _build_cluster_table(geom: TriangleGeometry, tri_mat: torch.Tensor):
    """The cluster table of a mesh past MAX_SMEM_TRIS triangles, up to the
    supercluster tier's MAX_SUPERCLUSTERS * SC_CLUSTERS clusters (4.19M
    triangles), in SAH leaf order, or morton order without the native
    builder (scene/device_scene.py:533-542); None for a smaller mesh."""
    n = geom.num_triangles
    if n <= MAX_SMEM_TRIS:
        return None
    cap = cluster_mod.MAX_SUPERCLUSTERS * cluster_mod.SC_CLUSTERS
    if -(-n // cluster_mod.LANES) > cap:
        raise NotImplementedError(
            f"{n} triangles: the cluster path stops at "
            f"{cap * cluster_mod.LANES} triangles, and the LBVH fallback "
            f"past it is not ported yet (ROADMAP.md Queue 1 item 6)")
    return cluster_mod.build_clusters(geom, tri_mat,
                                      order=native.sah_leaf_order(geom))


def _is_mirror(m) -> bool:
    return (m.get("kind", 0) == PBR and m.get("metallic", 0.0) > 0.99
            and m.get("roughness", 0.5) <= 0.05)


def material_features(materials) -> tuple:
    """The feature tags a list of material dicts switches on, in the
    reference's order (scene/device_scene.py:557-575)."""
    features = []
    if any(m.get("cutout", 0) or m.get("alpha_mode", 0) == 1
           for m in materials):
        features.append("cutouts")
    if any(m.get("kind", 0) == GLASS for m in materials):
        features.append("glass")
    if any(_is_mirror(m) for m in materials):
        features.append("mirror")
    if any(m.get("kind", 0) == PBR and not _is_mirror(m) for m in materials):
        features.append("pbr")
    return tuple(features)


def make_device_scene(vertices, indices, tri_mat, materials, device,
                      area_light=None, miss_color=(0.0, 0.0, 0.0),
                      normals=None, prims=None, instances=None):
    """Triangle mesh + material dicts (+ a CustomPrims table, + an
    InstanceTable over the mesh) → DeviceScene on `device`. normals:
    optional per-vertex [V, 3] shading normals. An instanced scene gets no
    cluster table."""
    if area_light is None:
        area_light = ParallelogramLight.make(
            (0, 0, 0), (1, 0, 0), (0, 0, 1), (0.0, 0.0, 0.0), device)
    table = make_material_table(materials, device)
    geom = build_triangle_geometry(vertices, indices, device, normals=normals)
    tri_mat_np = _check_tri_mat(tri_mat, geom.num_triangles, table.num)
    tri_mat = torch.as_tensor(tri_mat_np, device=device)
    if instances is not None:
        _check_instances(instances, tri_mat_np, geom.num_triangles, table.num)
    if prims is not None and prims.num and (
            int(prims.mat_id.min()) < 0
            or int(prims.mat_id.max()) >= table.num):
        raise ValueError(f"prim material ids must lie in [0, {table.num})")
    return DeviceScene(
        geom=geom, tri_mat=tri_mat, materials=table, area_light=area_light,
        miss_color=torch.as_tensor(miss_color, dtype=torch.float32,
                                   device=device),
        features=material_features(materials),
        clusters=(None if instances is not None
                  else _build_cluster_table(geom, tri_mat)),
        prims=prims, instances=instances)


def device_scene_from_numpy(fields, device) -> DeviceScene:
    """Build the port's scene from a JAX DeviceScene's fields, handed over as
    numpy arrays so both sides compute on the same bits. Keys:

      tri_consts [M,16], face_normal [M,3], valid [M], v0 / e1 / e2 [M,3],
      corner_normal [M,3,3], smooth (bool)              (scene.geom)
      tri_mat [M]
      mat_kind, mat_base_color, mat_emission, mat_metallic, mat_roughness,
      mat_ior, mat_kr                                   (scene.materials)
      light_corner, light_v1, light_v2, light_normal, light_emission
      miss_color [3]
      features (tuple of str)
      prim_kind [P], prim_params [P,18], prim_mat_id [P]  (scene.prims;
                                                       optional, P may be 0)
      num_clusters, cluster_comp [C,32,128], cluster_aabb [C_rows,6,128],
      cluster_slot_prim [C*128]                       (scene.clusters)
      inst_transform, inst_inv_transform [I,3,4], inst_sbt_offset,
      inst_instance_id [I], inst_prim_ranges (tuple of (lo, hi)),
      inst_row_ids (bool)                  (scene.instances; optional)

    A scene without a cluster table has num_clusters 0, one without
    instances I = 0.
    """
    def f32(key):
        return torch.as_tensor(np.array(fields[key], np.float32),
                               device=device)

    geom = TriangleGeometry(
        tri_consts=f32("tri_consts").contiguous(),
        face_normal=f32("face_normal"),
        valid=torch.as_tensor(np.array(fields["valid"], bool),
                              device=device),
        v0=f32("v0"), e1=f32("e1"), e2=f32("e2"),
        corner_normal=f32("corner_normal"), smooth=bool(fields["smooth"]))
    kind = np.asarray(fields["mat_kind"], np.int32)
    table = MaterialTable(
        kind=torch.as_tensor(kind, device=device),
        base_color=f32("mat_base_color"), emission=f32("mat_emission"),
        metallic=f32("mat_metallic"), roughness=f32("mat_roughness"),
        ior=f32("mat_ior"), kr=f32("mat_kr"))
    light = ParallelogramLight(
        corner=f32("light_corner"), v1=f32("light_v1"), v2=f32("light_v2"),
        normal=f32("light_normal"), emission=f32("light_emission"))
    tri_mat = _check_tri_mat(fields["tri_mat"], geom.num_triangles,
                             kind.shape[0])
    clusters = None
    if int(fields["num_clusters"]) > 0:
        clusters = cluster_mod.ClusterSet(
            comp=f32("cluster_comp").contiguous(),
            aabb=f32("cluster_aabb").contiguous(),
            slot_prim=torch.as_tensor(
                np.array(fields["cluster_slot_prim"], np.int32),
                device=device),
            num_clusters=int(fields["num_clusters"]))
    prims = None
    if "prim_kind" in fields:
        kinds = np.asarray(fields["prim_kind"], np.int32)
        prims = prim_mod.CustomPrims(
            kind=torch.as_tensor(kinds, device=device),
            params=f32("prim_params").reshape(-1, prim_mod.PARAM_COLS),
            mat_id=torch.as_tensor(np.asarray(fields["prim_mat_id"],
                                              np.int32), device=device),
            kinds_static=tuple(int(k) for k in kinds))
    instances = None
    if len(fields.get("inst_transform", ())):
        instances = InstanceTable(
            transform=f32("inst_transform"),
            inv_transform=f32("inst_inv_transform"),
            sbt_offset=torch.as_tensor(np.asarray(fields["inst_sbt_offset"],
                                                  np.int32), device=device),
            instance_id=torch.as_tensor(
                np.asarray(fields["inst_instance_id"], np.int32),
                device=device),
            prim_ranges=tuple((int(lo), int(hi))
                              for lo, hi in fields["inst_prim_ranges"]),
            row_ids=bool(fields["inst_row_ids"]))
        _check_instances(instances, tri_mat, geom.num_triangles,
                         kind.shape[0])
    return DeviceScene(geom=geom,
                       tri_mat=torch.as_tensor(tri_mat, device=device),
                       materials=table, area_light=light,
                       miss_color=f32("miss_color"),
                       features=tuple(fields.get("features", ())),
                       clusters=clusters, prims=prims, instances=instances)
