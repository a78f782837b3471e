"""Host-side Scene (counterpart of `scene/scene.py`): meshes, materials,
textures, cameras, lights and explicit instances added on the host or
loaded from a model file, then `finalize(device)` bakes them into the
port's DeviceScene.

`load` (scene/scene.py:105-199) reads an OBJ or PLY model into one diffuse
mesh (`io/meshio.py`), or a glTF / GLB model (`scene/gltf.py`) into its
materials (DIFFUSE or PBR, with textures, alpha modes and the CUT_TEXTURE
cutout for MASK), textures, meshes with their node transforms (or, given a
time, posed in world space by its animations, skins and morph targets),
point and directional lights and cameras. `default_camera` takes the first
glTF camera with the frame's aspect, else frames the bounding box.

Without instances, finalize bakes each mesh's transform into world space and
concatenates the meshes; past BVH_THRESHOLD_TRIS triangles it also builds the
scene's BVH (`with_bvh`, scene/scene.py:276-277). With instances, meshes stay
in object space, the shared geometry is the concatenation of the meshes
instances reference (a mesh no instance references gets an identity
instance), and each instance points at its mesh's static triangle range
(`accel/tlas.py`); a range past 512 triangles gets its own cluster table.

Texture images and the meshes' texture coordinates go to the DeviceScene
(zero uvs for a mesh without them, once any mesh has some, or always on an
instanced scene, as the reference does); so do the light dicts of
`add_light` or of the model (the Whitted integrator's light table), unless
finalize is given its own.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from ..core.camera import Camera
from ..shade import materials as mats
from ..shade.lights import DIRECTIONAL, POINT
from .device_scene import DeviceScene, make_device_scene
from .gltf import load_gltf, pose_meshes

# Past this many triangles finalize builds the scene's BVH
# (scene/scene.py:26, 276-277).
BVH_THRESHOLD_TRIS = 512


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


def _world(m: MeshEntry) -> np.ndarray:
    """The mesh's vertices through its own transform."""
    return m.positions @ m.transform[:3, :3].T + m.transform[:3, 3]


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
        self.cameras: list[Camera] = []
        self.lights: list[dict] = []
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
        """Add a light dict (shade/lights.py LightTable.make's keys)."""
        self.lights.append(dict(light))

    def add_camera(self, camera: Camera):
        self.cameras.append(camera)

    @classmethod
    def load(cls, path: str, time: Optional[float] = None,
             animation: int = 0) -> "Scene":
        """Load a .gltf / .glb / .obj / .ply model. time: pose the glTF
        model's animation `animation` (and its skins and morph targets) at
        this second, its meshes then in world space; None keeps the bind
        pose."""
        path = os.fspath(path)
        if os.path.splitext(path)[1].lower() in (".obj", ".ply"):
            from ..io.meshio import load_mesh
            v, f, n, uv = load_mesh(path)
            scene = cls()
            scene.add_material({"kind": mats.DIFFUSE,
                                "base_color": (0.75, 0.75, 0.75)})
            scene.add_mesh(v, f, normals=n, uvs=uv, material=0)
            return scene
        g = load_gltf(path)
        scene = cls()
        for m in g.materials:
            kind = (mats.PBR if (m.metallic > 0.0 or m.base_color_texture >= 0)
                    else mats.DIFFUSE)
            scene.add_material({
                "kind": kind,
                "base_color": tuple(m.base_color[:3]),
                "metallic": m.metallic,
                "roughness": m.roughness,
                "emission": tuple(m.emissive),
                "base_tex": m.base_color_texture,
                "normal_tex": m.normal_texture,
                "mr_tex": m.mr_texture,
                "emissive_tex": m.emissive_texture,
                "alpha_mode": (mats.ALPHA_MASK if m.alpha_mode == "MASK"
                               else mats.ALPHA_BLEND if m.alpha_mode == "BLEND"
                               else mats.ALPHA_OPAQUE),
                "alpha_cutoff": m.alpha_cutoff,
                # MASK cuts against the base-color texture's alpha
                "cutout": (mats.CUT_TEXTURE if m.alpha_mode == "MASK"
                           else mats.CUT_NONE),
            })
        if not scene.materials:
            scene.add_material({"kind": mats.DIFFUSE,
                                "base_color": (0.7, 0.7, 0.7)})
        for t in g.textures:
            scene.add_texture(t)
        posed = None
        if time is not None and (g.animations or g.skins):
            posed = {mi: (p, n) for mi, p, n in
                     pose_meshes(g, time, animation=animation)}
        for i, mesh in enumerate(g.meshes):
            if posed is not None and i in posed:
                p, n = posed[i]            # already in world space
                scene.add_mesh(p, mesh.indices, n, mesh.uvs,
                               material=max(mesh.material, 0),
                               name=mesh.name)
            else:
                scene.add_mesh(mesh.positions, mesh.indices, mesh.normals,
                               mesh.uvs, material=max(mesh.material, 0),
                               transform=mesh.transform, name=mesh.name)
        for li in g.lights:
            # KHR_lights_punctual: a point light at its node's origin, a
            # directional light down its node's -Z
            if li.kind == "point":
                scene.lights.append({
                    "kind": POINT,
                    "position": tuple(float(x) for x in li.transform[:3, 3]),
                    "color": tuple(c * li.intensity for c in li.color)})
            elif li.kind == "directional":
                d = -li.transform[:3, 2]
                scene.lights.append({
                    "kind": DIRECTIONAL,
                    "direction": tuple(float(x) for x in d),
                    "color": tuple(c * li.intensity for c in li.color)})
        for cam in g.cameras:
            # a glTF camera looks down its node's -Z
            eye = cam.transform[:3, 3]
            fwd = -cam.transform[:3, 2]
            up = cam.transform[:3, 1]
            scene.cameras.append(Camera(
                eye=tuple(eye), lookat=tuple(eye + fwd), up=tuple(up),
                fov_y=float(np.degrees(cam.yfov)), aspect=cam.aspect))
        return scene

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

    def aabb(self):
        """(lo, hi) float64 [3] of the meshes' world-space vertices; +inf /
        -inf without meshes."""
        lo = np.full(3, np.inf)
        hi = np.full(3, -np.inf)
        for m in self.meshes:
            world = _world(m)
            lo = np.minimum(lo, world.min(axis=0))
            hi = np.maximum(hi, world.max(axis=0))
        return lo, hi

    def default_camera(self, width, height) -> Camera:
        """The first camera (a glTF camera), given the frame's aspect, else
        a camera framing the scene's bounding box (scene/scene.py:
        207-220)."""
        if self.cameras:
            cam = dataclasses.replace(self.cameras[0])
            cam.aspect = width / height
            return cam
        lo, hi = self.aabb()
        center = 0.5 * (lo + hi)
        extent = float(np.linalg.norm(hi - lo))
        eye = center + np.array([0.6, 0.45, 1.5]) * extent
        return Camera(eye=tuple(eye), lookat=tuple(center),
                      up=(0, 1, 0), fov_y=35.0, aspect=width / height)

    def _materials(self):
        return self.materials or [{"kind": mats.DIFFUSE}]

    def finalize(self, device, lights=None, area_light=None,
                 with_bvh: Optional[bool] = None) -> DeviceScene:
        """The DeviceScene on `device`: flat, or two-level once an instance
        exists. lights: light dicts for the scene's light table, in place of
        those of add_light. with_bvh: build the flat scene's BVH; None
        builds it past BVH_THRESHOLD_TRIS triangles (scene/scene.py:
        276-277). A two-level scene builds none."""
        lights = self.lights if lights is None else lights
        if self.instances:
            return self._finalize_instanced(device, lights, area_light)
        all_pos, all_idx, all_n, all_uv, tri_mat = [], [], [], [], []
        base = 0
        for m in self.meshes:
            all_pos.append(_world(m).astype(np.float32))
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
        indices = np.concatenate(all_idx)
        if with_bvh is None:
            with_bvh = len(indices) > BVH_THRESHOLD_TRIS
        return make_device_scene(
            np.concatenate(all_pos), indices,
            np.concatenate(tri_mat), self._materials(), device,
            area_light=area_light, miss_color=self.miss_color,
            normals=normals, uvs=uvs, textures=self.textures, lights=lights,
            with_bvh=with_bvh)

    def _finalize_instanced(self, device, lights, area_light) -> DeviceScene:
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
            obj = _world(m)
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
            textures=self.textures, lights=lights)
