"""Host-side Scene (counterpart of `scene/scene.py:28-101, 222-346`):
meshes, materials and explicit instances added on the host, then
`finalize(device)` bakes them into the port's DeviceScene.

Without instances, finalize bakes each mesh's transform into world space and
concatenates the meshes. With instances, meshes stay in object space, the
shared geometry is the concatenation of the meshes instances reference (a
mesh no instance references gets an identity instance), and each instance
points at its mesh's static triangle range (`accel/tlas.py`).

Texture images added with `add_texture` and the meshes' texture
coordinates go to the DeviceScene (zero uvs for a mesh without them, once
any mesh has some, or always on an instanced scene, as the reference does).
Not ported here: the loaders (`load`, ROADMAP.md Queue 1 item 13) and point
/ directional lights (the Whitted integrator's, Queue 1 item 7); each raises
NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..shade import materials as mats
from .device_scene import DeviceScene, make_device_scene


@dataclasses.dataclass
class MeshEntry:
    positions: np.ndarray
    indices: np.ndarray
    normals: Optional[np.ndarray]
    uvs: Optional[np.ndarray]
    material: object          # one int, or a per-triangle int array
    transform: np.ndarray     # [4, 4]
    name: str = ""


def _mesh_tri_mat(m: MeshEntry) -> np.ndarray:
    """Per-triangle material ids of a mesh entry: `material` is one id or
    one per triangle."""
    if np.ndim(m.material) == 0:
        return np.full(len(m.indices), m.material, np.int32)
    arr = np.asarray(m.material, np.int32)
    if arr.shape != (len(m.indices),):
        raise ValueError(f"{arr.shape[0]} material ids for "
                         f"{len(m.indices)} triangles")
    return arr


def _object_normals(m: MeshEntry):
    """The mesh's normals through its own transform's inverse transpose,
    normalised (scene/scene.py:233-238), or None."""
    if m.normals is None:
        return None
    inv_t = np.linalg.inv(m.transform[:3, :3]).T
    n = m.normals @ inv_t.T
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
    return n


def _uvs(positions, uvs) -> np.ndarray:
    """A mesh's texture coordinates, or zeros for each of its vertices."""
    return (np.zeros((len(positions), 2), np.float32) if uvs is None
            else uvs)


class Scene:
    def __init__(self):
        self.meshes: list[MeshEntry] = []
        self.materials: list[dict] = []
        self.textures: list[np.ndarray] = []
        # (mesh index, 4x4 transform, sbt offset) per explicit instance
        self.instances: list[tuple] = []
        self.miss_color = (0.05, 0.05, 0.12)

    def add_material(self, material: dict) -> int:
        self.materials.append(dict(material))
        return len(self.materials) - 1

    def add_texture(self, image) -> int:
        """Add an image ([H, W, 3 | 4] or [H, W], uint8 or float) → its
        texture id, for a material's base_tex / normal_tex / mr_tex /
        emissive_tex."""
        self.textures.append(np.asarray(image))
        return len(self.textures) - 1

    def add_light(self, light: dict):
        raise NotImplementedError("point and directional lights (the Whitted "
                                  "integrator's) are not ported yet "
                                  "(ROADMAP.md Queue 1 item 7)")

    @classmethod
    def load(cls, path: str, **kwargs) -> "Scene":
        raise NotImplementedError("the glTF / OBJ / PLY loaders are not "
                                  "ported yet (ROADMAP.md Queue 1 item 13)")

    def add_mesh(self, positions, indices, normals=None, uvs=None,
                 material=0, transform=None, name="") -> int:
        self.meshes.append(MeshEntry(
            positions=np.asarray(positions, np.float32),
            indices=np.asarray(indices, np.int32).reshape(-1, 3),
            normals=(None if normals is None
                     else np.asarray(normals, np.float32)),
            uvs=None if uvs is None else np.asarray(uvs, np.float32),
            material=material,
            transform=(np.eye(4, dtype=np.float32) if transform is None
                       else np.asarray(transform, np.float32)),
            name=name))
        return len(self.meshes) - 1

    def add_instance(self, mesh_index: int, transform=None,
                     sbt_offset: int = 0) -> int:
        """Instance an added mesh under a world transform, its hits' material
        ids offset by `sbt_offset`. Once an instance exists, finalize emits
        the two-level scene."""
        t = (np.eye(4, dtype=np.float32) if transform is None
             else np.asarray(transform, np.float32))
        self.instances.append((int(mesh_index), t, int(sbt_offset)))
        return len(self.instances) - 1

    def _materials(self):
        return self.materials or [{"kind": mats.DIFFUSE}]

    def finalize(self, device, area_light=None) -> DeviceScene:
        """The DeviceScene on `device`: flat, or two-level once an instance
        exists."""
        if self.instances:
            return self._finalize_instanced(device, area_light)
        all_pos, all_idx, all_n, all_uv, tri_mat = [], [], [], [], []
        base = 0
        for m in self.meshes:
            world = m.positions @ m.transform[:3, :3].T + m.transform[:3, 3]
            all_pos.append(world.astype(np.float32))
            all_idx.append(m.indices + base)
            all_n.append(_object_normals(m))
            all_uv.append(m.uvs)
            tri_mat.append(_mesh_tri_mat(m))
            base += len(m.positions)
        if not all_pos:
            all_pos = [np.zeros((3, 3), np.float32)]
            all_idx = [np.zeros((1, 3), np.int32)]
            all_n = [None]
            all_uv = [None]
            tri_mat = [np.zeros(1, np.int32)]
        # Meshes without normals get zero normals: shading_frame then falls
        # back to the face normal per hit.
        normals = (np.concatenate([n if n is not None else np.zeros_like(p)
                                   for p, n in zip(all_pos, all_n)])
                   if any(n is not None for n in all_n) else None)
        uvs = (np.concatenate([_uvs(p, u) for p, u in zip(all_pos, all_uv)])
               if any(u is not None for u in all_uv) else None)
        return make_device_scene(
            np.concatenate(all_pos), np.concatenate(all_idx),
            np.concatenate(tri_mat), self._materials(), device,
            area_light=area_light, miss_color=self.miss_color,
            normals=normals, uvs=uvs, textures=self.textures)

    def _finalize_instanced(self, device, area_light) -> DeviceScene:
        """Meshes in object space (their own transform baked in), the shared
        geometry the concatenation of the referenced meshes, one range per
        mesh; unreferenced meshes get an identity instance."""
        from ..accel.tlas import make_instances
        inst = list(self.instances)
        used = {mi for mi, _, _ in inst}
        for mi in range(len(self.meshes)):
            if mi not in used:
                inst.append((mi, np.eye(4, dtype=np.float32), 0))
        ranges = {}
        all_pos, all_idx, all_n, all_uv, tri_mat = [], [], [], [], []
        vbase = tbase = 0
        for mi in sorted({mi for mi, _, _ in inst}):
            m = self.meshes[mi]
            obj = m.positions @ m.transform[:3, :3].T + m.transform[:3, 3]
            all_pos.append(obj.astype(np.float32))
            all_idx.append(m.indices + vbase)
            all_n.append(_object_normals(m))
            all_uv.append(_uvs(obj, m.uvs))
            tri_mat.append(_mesh_tri_mat(m))
            ranges[mi] = (tbase, tbase + len(m.indices))
            vbase += len(m.positions)
            tbase += len(m.indices)
        table = make_instances(
            [t for _, t, _ in inst], device,
            sbt_offsets=np.asarray([s for _, _, s in inst], np.int32),
            prim_ranges=[ranges[mi] for mi, _, _ in inst])
        normals = (np.concatenate([
            n if n is not None else np.zeros((len(p), 3), np.float32)
            for p, n in zip(all_pos, all_n)])
            if any(n is not None for n in all_n) else None)
        return make_device_scene(
            np.concatenate(all_pos), np.concatenate(all_idx),
            np.concatenate(tri_mat), self._materials(), device,
            area_light=area_light, miss_color=self.miss_color,
            normals=normals, instances=table, uvs=np.concatenate(all_uv),
            textures=self.textures)
