"""The torch DeviceScene, Cornell subset (counterpart of
`scene/device_scene.py:32-175, 474`).

The port's scene holds triangle geometry, per-triangle material ids, the
material table, the parallelogram area light, the miss color and the static
feature tags. Custom prims, instances, clusters, BVHs, textures, volumes and
motion are not ported yet (ROADMAP.md Queue 1 items 6-9).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..accel.geometry import TriangleGeometry, build_triangle_geometry
from ..shade.lights import ParallelogramLight
from ..shade.materials import MaterialTable, make_material_table

# Feature tags of the JAX DeviceScene that the slice does not render yet.
UNPORTED_FEATURES = {"glass": 7, "mirror": 7, "pbr": 7, "cutouts": 8,
                     "volume": 9}


@dataclasses.dataclass
class DeviceScene:
    geom: TriangleGeometry
    tri_mat: torch.Tensor               # [M] int32 material id per triangle
    materials: MaterialTable
    area_light: ParallelogramLight      # NEE target
    miss_color: torch.Tensor            # [3] constant background
    features: tuple = ()

    @property
    def num_triangles(self):
        return self.geom.num_triangles

    @property
    def device(self):
        return self.geom.tri_consts.device

    def require_cornell_subset(self):
        """Raise for the features the port does not render yet."""
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


def make_device_scene(vertices, indices, tri_mat, materials, device,
                      area_light=None, miss_color=(0.0, 0.0, 0.0)):
    """Triangle mesh + material dicts → DeviceScene on `device`."""
    if area_light is None:
        area_light = ParallelogramLight.make(
            (0, 0, 0), (1, 0, 0), (0, 0, 1), (0.0, 0.0, 0.0), device)
    table = make_material_table(materials, device)
    geom = build_triangle_geometry(vertices, indices, device)
    tri_mat = _check_tri_mat(tri_mat, geom.num_triangles, table.num)
    return DeviceScene(
        geom=geom, tri_mat=torch.as_tensor(tri_mat, device=device),
        materials=table, area_light=area_light,
        miss_color=torch.as_tensor(miss_color, dtype=torch.float32,
                                   device=device))


def device_scene_from_numpy(fields, device) -> DeviceScene:
    """Build the port's scene from a JAX DeviceScene's fields, handed over as
    numpy arrays so both sides compute on the same bits. Keys:

      tri_consts [M,16], face_normal [M,3], valid [M]   (scene.geom)
      tri_mat [M]
      mat_kind, mat_base_color, mat_emission, mat_metallic, mat_roughness,
      mat_ior, mat_kr                                   (scene.materials)
      light_corner, light_v1, light_v2, light_normal, light_emission
      miss_color [3]
      features (tuple of str)
    """
    def f32(key):
        return torch.as_tensor(np.array(fields[key], np.float32),
                               device=device)

    geom = TriangleGeometry(
        tri_consts=f32("tri_consts").contiguous(),
        face_normal=f32("face_normal"),
        valid=torch.as_tensor(np.array(fields["valid"], bool),
                              device=device))
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
    return DeviceScene(geom=geom,
                       tri_mat=torch.as_tensor(tri_mat, device=device),
                       materials=table, area_light=light,
                       miss_color=f32("miss_color"),
                       features=tuple(fields.get("features", ())))
