"""glTF 2.0 loader (counterpart of `scene/gltf.py`, in full): .gltf with
external or base64 buffers and .glb, the node hierarchy, pbrMetallicRoughness
materials with KHR_materials_emissive_strength and KHR_texture_transform,
images (PNG / JPEG through PIL, KHR_texture_basisu KTX2 through
`io/ktx2.py`), KHR_lights_punctual, cameras, animations (TRS channels with
slerp, `sample_animation`, `node_world_transforms`), skins and morph
targets (`pose_meshes`). The role of tinygltf + `sutil::loadScene`
(`SDK/sutil/Scene.cpp:267-560`). numpy only: PIL is imported where a PNG or
JPEG payload is decoded, so KTX2 textures need no image package.
"""
from __future__ import annotations

import base64
import json
import os
import struct
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
                "MAT3": 9, "MAT4": 16}


@dataclass
class GltfMesh:
    positions: np.ndarray            # [V, 3] f32 (object space)
    indices: np.ndarray              # [M, 3] i32
    normals: Optional[np.ndarray]    # [V, 3] or None
    uvs: Optional[np.ndarray]        # [V, 2] or None
    material: int                    # material index (-1 = default)
    transform: np.ndarray            # [4, 4] node-to-world
    name: str = ""
    joints: Optional[np.ndarray] = None   # [V, 4] i32 (skinned meshes)
    weights: Optional[np.ndarray] = None  # [V, 4] f32
    skin: int = -1                   # index into GltfScene.skins
    # morph targets: list of [V, 3] POSITION deltas + default weights
    targets: list = field(default_factory=list)
    morph_weights: list = field(default_factory=list)
    # per-target [V, 3] NORMAL deltas (None where a target has none).
    # TANGENT deltas are intentionally not stored: this framework derives
    # tangents from the morphed positions+uvs at build time
    # (accel/geometry.py shading-frame tangents), so they track morphs
    # automatically.
    targets_normal: list = field(default_factory=list)


@dataclass
class GltfMaterial:
    base_color: tuple = (1.0, 1.0, 1.0, 1.0)
    metallic: float = 1.0
    roughness: float = 1.0
    emissive: tuple = (0.0, 0.0, 0.0)
    base_color_texture: int = -1     # texture index
    normal_texture: int = -1         # tangent-space normal map
    mr_texture: int = -1             # metallic-roughness map (G=r, B=m)
    emissive_texture: int = -1
    alpha_mode: str = "OPAQUE"
    alpha_cutoff: float = 0.5
    name: str = ""


@dataclass
class GltfCamera:
    transform: np.ndarray            # [4, 4]
    yfov: float = 0.8
    aspect: float = 1.0


@dataclass
class GltfChannel:
    """One animation channel: a sampler driving a node's T/R/S path."""
    node: int
    path: str                        # "translation" | "rotation" | "scale"
    times: np.ndarray                # [K] f32 keyframe times (seconds)
    values: np.ndarray               # [K, 3|4] (CUBICSPLINE: [K, 3, 3|4])
    interpolation: str = "LINEAR"    # LINEAR | STEP | CUBICSPLINE


@dataclass
class GltfAnimation:
    name: str
    channels: list                   # [GltfChannel]

    @property
    def duration(self) -> float:
        return max((float(c.times[-1]) for c in self.channels if len(c.times)),
                   default=0.0)


@dataclass
class GltfSkin:
    joints: list                     # node indices
    inverse_bind: np.ndarray         # [J, 4, 4]


@dataclass
class GltfLight:
    """KHR_lights_punctual light placed by a node."""
    kind: str                        # "point" | "directional" | "spot"
    color: tuple
    intensity: float
    transform: np.ndarray            # [4, 4] node-to-world


@dataclass
class GltfScene:
    meshes: list = field(default_factory=list)
    materials: list = field(default_factory=list)
    textures: list = field(default_factory=list)   # np.uint8 [H, W, 4]
    cameras: list = field(default_factory=list)
    animations: list = field(default_factory=list)  # [GltfAnimation]
    skins: list = field(default_factory=list)       # [GltfSkin]
    lights: list = field(default_factory=list)      # [GltfLight]
    # Raw node data retained so animation can re-pose the hierarchy:
    nodes: list = field(default_factory=list)       # gltf "nodes" dicts
    roots: list = field(default_factory=list)       # scene root node ids
    # node index -> list of (mesh_list_index, skin_index|-1) produced by it
    node_meshes: dict = field(default_factory=dict)


def _load_buffers(gltf, base_dir, glb_chunk):
    buffers = []
    for buf in gltf.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            buffers.append(glb_chunk)
        elif uri.startswith("data:"):
            b64 = uri.split(",", 1)[1]
            buffers.append(base64.b64decode(b64))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                buffers.append(f.read())
    return buffers


def _read_accessor(gltf, buffers, idx):
    acc = gltf["accessors"][idx]
    count = acc["count"]
    n_comp = _TYPE_COUNTS[acc["type"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    itemsize = np.dtype(dtype).itemsize

    if "bufferView" not in acc:
        data = np.zeros((count, n_comp), dtype)
    else:
        bv = gltf["bufferViews"][acc["bufferView"]]
        buf = buffers[bv["buffer"]]
        offset = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = bv.get("byteStride") or n_comp * itemsize
        if stride == n_comp * itemsize:
            data = np.frombuffer(buf, dtype, count * n_comp, offset)
            data = data.reshape(count, n_comp)
        else:
            raw = np.frombuffer(buf, np.uint8,
                                stride * (count - 1) + n_comp * itemsize,
                                offset)
            data = np.lib.stride_tricks.as_strided(
                raw.view(dtype), shape=(count, n_comp),
                strides=(stride, itemsize)).copy()

    if acc.get("sparse"):
        data = data.copy()
        sp = acc["sparse"]
        idx_acc = {"count": sp["count"], "type": "SCALAR",
                   "componentType": sp["indices"]["componentType"],
                   "bufferView": sp["indices"]["bufferView"],
                   "byteOffset": sp["indices"].get("byteOffset", 0)}
        val_acc = {"count": sp["count"], "type": acc["type"],
                   "componentType": acc["componentType"],
                   "bufferView": sp["values"]["bufferView"],
                   "byteOffset": sp["values"].get("byteOffset", 0)}
        g2 = dict(gltf)
        g2["accessors"] = [idx_acc, val_acc]
        sp_idx = _read_accessor(g2, buffers, 0).reshape(-1).astype(np.int64)
        sp_val = _read_accessor(g2, buffers, 1)
        data[sp_idx] = sp_val

    # normalized integer attributes → float
    if acc.get("normalized"):
        info = np.iinfo(dtype)
        data = data.astype(np.float32) / info.max
    return data


def _node_matrix(node):
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        m = np.diag(list(node["scale"]) + [1.0]).astype(np.float32) @ m
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        rot = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w), 0],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w), 0],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y), 0],
            [0, 0, 0, 1]], np.float32)
        m = rot @ m
    if "translation" in node:
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def _decode_image(gltf, buffers, base_dir, img):
    from ..io import ktx2 as ktx2_mod
    if "uri" in img:
        uri = img["uri"]
        if uri.startswith("data:"):
            raw = base64.b64decode(uri.split(",", 1)[1])
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                raw = f.read()
    else:
        bv = gltf["bufferViews"][img["bufferView"]]
        off = bv.get("byteOffset", 0)
        raw = buffers[bv["buffer"]][off:off + bv["byteLength"]]
    if ktx2_mod.is_ktx2(raw):
        # KHR_texture_basisu image payload (uncompressed/zstd/zlib levels)
        return ktx2_mod.read_ktx2_rgba(raw)
    from PIL import Image
    import io
    im = Image.open(io.BytesIO(raw))
    return np.asarray(im.convert("RGBA"))


def load_gltf(path: str) -> GltfScene:
    """Parse a .gltf/.glb file into a GltfScene (world-space transforms)."""
    base_dir = os.path.dirname(os.path.abspath(path))
    glb_chunk = None
    if path.lower().endswith(".glb"):
        with open(path, "rb") as f:
            data = f.read()
        magic, _version, _length = struct.unpack_from("<III", data, 0)
        assert magic == 0x46546C67, "not a GLB file"
        offset = 12
        gltf = None
        while offset < len(data):
            clen, ctype = struct.unpack_from("<II", data, offset)
            chunk = data[offset + 8: offset + 8 + clen]
            if ctype == 0x4E4F534A:      # JSON
                gltf = json.loads(chunk)
            elif ctype == 0x004E4942:    # BIN
                glb_chunk = chunk
            offset += 8 + clen
        assert gltf is not None, "GLB missing JSON chunk"
    else:
        with open(path) as f:
            gltf = json.load(f)

    buffers = _load_buffers(gltf, base_dir, glb_chunk)
    out = GltfScene()

    for m in gltf.get("materials", []):
        pbr = m.get("pbrMetallicRoughness", {})
        tex = pbr.get("baseColorTexture", {}).get("index", -1)
        # KHR_materials_emissive_strength scales the emissive factor
        # (emissiveFactor is clamped to [0,1] by the spec; HDR emitters
        # need the extension)
        em_scale = m.get("extensions", {}).get(
            "KHR_materials_emissive_strength", {}).get(
                "emissiveStrength", 1.0)
        emissive = tuple(float(e) * em_scale
                         for e in m.get("emissiveFactor", (0, 0, 0)))
        out.materials.append(GltfMaterial(
            base_color=tuple(pbr.get("baseColorFactor", (1, 1, 1, 1))),
            metallic=pbr.get("metallicFactor", 1.0),
            roughness=pbr.get("roughnessFactor", 1.0),
            emissive=emissive,
            base_color_texture=tex,
            normal_texture=m.get("normalTexture", {}).get("index", -1),
            mr_texture=pbr.get("metallicRoughnessTexture",
                               {}).get("index", -1),
            emissive_texture=m.get("emissiveTexture", {}).get("index", -1),
            alpha_mode=m.get("alphaMode", "OPAQUE"),
            alpha_cutoff=m.get("alphaCutoff", 0.5),
            name=m.get("name", ""),
        ))

    # texture index → decoded image (through the texture→image indirection)
    images = None
    for tex in gltf.get("textures", []):
        if images is None:
            images = [None] * len(gltf.get("images", []))
        # KHR_texture_basisu points at a KTX2 image instead of source
        src = tex.get("extensions", {}).get(
            "KHR_texture_basisu", {}).get("source", tex.get("source", 0))
        if images[src] is None:
            images[src] = _decode_image(gltf, buffers, base_dir,
                                        gltf["images"][src])
        out.textures.append(images[src])

    # skins (joint lists + inverse bind matrices)
    for sk in gltf.get("skins", []):
        if "inverseBindMatrices" in sk:
            ibm = _read_accessor(gltf, buffers, sk["inverseBindMatrices"])
            ibm = ibm.reshape(-1, 4, 4).transpose(0, 2, 1)  # column-major
        else:
            ibm = np.broadcast_to(np.eye(4, dtype=np.float32),
                                  (len(sk["joints"]), 4, 4)).copy()
        out.skins.append(GltfSkin(joints=list(sk["joints"]),
                                  inverse_bind=ibm.astype(np.float32)))

    # animations: channels + samplers
    for an in gltf.get("animations", []):
        chans = []
        for ch in an.get("channels", []):
            tgt = ch.get("target", {})
            if "node" not in tgt or tgt.get("path") not in (
                    "translation", "rotation", "scale", "weights"):
                continue
            sm = an["samplers"][ch["sampler"]]
            times = _read_accessor(gltf, buffers,
                                   sm["input"]).reshape(-1).astype(np.float32)
            vals = _read_accessor(gltf, buffers,
                                  sm["output"]).astype(np.float32)
            interp = sm.get("interpolation", "LINEAR")
            if interp == "CUBICSPLINE":
                vals = vals.reshape(len(times), 3, -1)
            elif tgt["path"] == "weights":
                # morph weights: K*T scalars → [K, T]
                vals = vals.reshape(len(times), -1)
            chans.append(GltfChannel(node=tgt["node"], path=tgt["path"],
                                     times=times, values=vals,
                                     interpolation=interp))
        out.animations.append(GltfAnimation(name=an.get("name", ""),
                                            channels=chans))

    # walk node hierarchy (Scene.cpp:125-207 processGLTFNode)
    scene_idx = gltf.get("scene", 0)
    roots = gltf.get("scenes", [{}])[scene_idx].get("nodes", [])
    nodes = gltf.get("nodes", [])
    out.nodes = nodes
    out.roots = list(roots)

    def walk(node_idx, parent_m):
        node = nodes[node_idx]
        m = parent_m @ _node_matrix(node)
        if "camera" in node:
            cam = gltf["cameras"][node["camera"]]
            persp = cam.get("perspective", {})
            out.cameras.append(GltfCamera(
                transform=m, yfov=persp.get("yfov", 0.8),
                aspect=persp.get("aspectRatio", 1.0)))
        light_idx = node.get("extensions", {}).get(
            "KHR_lights_punctual", {}).get("light")
        if light_idx is not None:
            ld = gltf.get("extensions", {}).get(
                "KHR_lights_punctual", {}).get("lights", [])[light_idx]
            out.lights.append(GltfLight(
                kind=ld.get("type", "point"),
                color=tuple(ld.get("color", (1.0, 1.0, 1.0))),
                intensity=float(ld.get("intensity", 1.0)),
                transform=m))
        if "mesh" in node:
            mesh = gltf["meshes"][node["mesh"]]
            skin_idx = node.get("skin", -1)
            for prim in mesh.get("primitives", []):
                if prim.get("mode", 4) != 4:
                    continue  # triangles only
                attrs = prim["attributes"]
                pos = _read_accessor(gltf, buffers,
                                     attrs["POSITION"]).astype(np.float32)
                if "indices" in prim:
                    idx = _read_accessor(gltf, buffers, prim["indices"])
                    idx = idx.reshape(-1, 3).astype(np.int32)
                else:
                    idx = np.arange(len(pos), dtype=np.int32).reshape(-1, 3)
                normals = None
                if "NORMAL" in attrs:
                    normals = _read_accessor(
                        gltf, buffers, attrs["NORMAL"]).astype(np.float32)
                uvs = None
                if "TEXCOORD_0" in attrs:
                    uvs = _read_accessor(
                        gltf, buffers, attrs["TEXCOORD_0"]).astype(np.float32)
                    # KHR_texture_transform on the base-color texture:
                    # bake offset/scale/rotation into the prim's uvs
                    mat_i = prim.get("material", -1)
                    if 0 <= mat_i < len(gltf.get("materials", [])):
                        tt = gltf["materials"][mat_i].get(
                            "pbrMetallicRoughness", {}).get(
                            "baseColorTexture", {}).get(
                            "extensions", {}).get("KHR_texture_transform")
                        if tt:
                            uvs = _apply_texture_transform(uvs, tt)
                targets = []
                targets_n = []
                for tg in prim.get("targets", []):
                    targets.append(
                        _read_accessor(gltf, buffers,
                                       tg["POSITION"]).astype(
                                           np.float32)[:, :3]
                        if "POSITION" in tg
                        else np.zeros((len(pos), 3), np.float32))
                    targets_n.append(
                        _read_accessor(gltf, buffers,
                                       tg["NORMAL"]).astype(
                                           np.float32)[:, :3]
                        if "NORMAL" in tg else None)
                morph_w = [float(x) for x in node.get(
                    "weights", mesh.get("weights",
                                        [0.0] * len(targets)))]
                if targets and any(w != 0.0 for w in morph_w):
                    # bake the DEFAULT morph state into the base positions
                    # (spec: default weights always apply); animation then
                    # applies (w(t) - default) deltas on top.
                    pos = pos.copy()
                    for w_t, delta in zip(morph_w, targets):
                        pos[:, :3] = pos[:, :3] + np.float32(w_t) * delta
                    if (normals is not None
                            and any(tn is not None for tn in targets_n)):
                        normals = normals.copy()
                        for w_t, dn in zip(morph_w, targets_n):
                            if dn is not None:
                                normals = normals + np.float32(w_t) * dn
                        normals /= np.maximum(
                            np.linalg.norm(normals, axis=1, keepdims=True),
                            1e-8)
                joints = weights = None
                if skin_idx >= 0 and "JOINTS_0" in attrs:
                    joints = _read_accessor(
                        gltf, buffers, attrs["JOINTS_0"]).astype(np.int32)
                    weights = _read_accessor(
                        gltf, buffers,
                        attrs["WEIGHTS_0"]).astype(np.float32)
                    wsum = np.maximum(weights.sum(axis=1, keepdims=True),
                                      1e-8)
                    weights = weights / wsum
                mi = len(out.meshes)
                out.meshes.append(GltfMesh(
                    positions=pos[:, :3], indices=idx, normals=normals,
                    uvs=uvs, material=prim.get("material", -1),
                    transform=m, name=mesh.get("name", ""),
                    joints=joints, weights=weights, skin=skin_idx,
                    targets=targets, morph_weights=morph_w,
                    targets_normal=targets_n))
                out.node_meshes.setdefault(node_idx, []).append(mi)
        for child in node.get("children", []):
            walk(child, m)

    for r in roots:
        walk(r, np.eye(4, dtype=np.float32))
    return out


def _apply_texture_transform(uvs, tt):
    """Bake a KHR_texture_transform (offset/rotation/scale) into uvs."""
    u = uvs[:, 0] * tt.get("scale", (1, 1))[0]
    v = uvs[:, 1] * tt.get("scale", (1, 1))[1]
    r = tt.get("rotation", 0.0)
    if r:
        cr, sr = np.cos(r), np.sin(r)
        u, v = cr * u + sr * v, -sr * u + cr * v
    off = tt.get("offset", (0, 0))
    return np.stack([u + off[0], v + off[1]], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# Animation + skinning evaluation
# ---------------------------------------------------------------------------

def _slerp(q0, q1, f):
    """Quaternion slerp (xyzw), shortest path — GLTF LINEAR rotation."""
    d = float(np.dot(q0, q1))
    if d < 0.0:
        q1 = -q1
        d = -d
    if d > 0.9995:
        q = q0 + f * (q1 - q0)
        return q / np.linalg.norm(q)
    th = np.arccos(np.clip(d, -1.0, 1.0))
    return ((np.sin((1 - f) * th) * q0 + np.sin(f * th) * q1)
            / np.sin(th)).astype(np.float32)


def _sample_channel(ch: GltfChannel, t: float):
    """Evaluate one channel at time t (clamped to the key range)."""
    times = ch.times
    if len(times) == 1:
        v = ch.values[0]
        return v[1] if ch.interpolation == "CUBICSPLINE" else v
    t = float(np.clip(t, times[0], times[-1]))
    k = int(np.searchsorted(times, t, side="right") - 1)
    k = min(max(k, 0), len(times) - 2)
    t0, t1 = float(times[k]), float(times[k + 1])
    f = 0.0 if t1 <= t0 else (t - t0) / (t1 - t0)
    if ch.interpolation == "STEP":
        return ch.values[k]
    if ch.interpolation == "CUBICSPLINE":
        # values [K, 3, C]: in-tangent, value, out-tangent
        dt = t1 - t0
        p0 = ch.values[k, 1]
        m0 = ch.values[k, 2] * dt
        p1 = ch.values[k + 1, 1]
        m1 = ch.values[k + 1, 0] * dt
        f2, f3 = f * f, f * f * f
        v = ((2 * f3 - 3 * f2 + 1) * p0 + (f3 - 2 * f2 + f) * m0
             + (-2 * f3 + 3 * f2) * p1 + (f3 - f2) * m1)
        if ch.path == "rotation":
            v = v / max(np.linalg.norm(v), 1e-12)
        return v.astype(np.float32)
    if ch.path == "rotation":
        return _slerp(ch.values[k], ch.values[k + 1], f)
    return ((1 - f) * ch.values[k] + f * ch.values[k + 1]).astype(np.float32)


def sample_animation(anim: GltfAnimation, t: float) -> dict:
    """Animation state at time t → {node_index: {path: value}} overrides."""
    overrides: dict = {}
    for ch in anim.channels:
        overrides.setdefault(ch.node, {})[ch.path] = _sample_channel(ch, t)
    return overrides


def _node_matrix_posed(node, over):
    if over:
        node = dict(node)
        node.pop("matrix", None)         # TRS overrides replace the matrix
        for path, v in over.items():
            node[path] = [float(x) for x in np.asarray(v).reshape(-1)]
    return _node_matrix(node)


def node_world_transforms(scene: GltfScene, overrides=None) -> dict:
    """{node_index: [4,4] world transform} for the posed hierarchy."""
    overrides = overrides or {}
    out = {}

    def walk(ni, parent):
        m = parent @ _node_matrix_posed(scene.nodes[ni],
                                        overrides.get(ni))
        out[ni] = m
        for c in scene.nodes[ni].get("children", []):
            walk(c, m)

    for r in scene.roots:
        walk(r, np.eye(4, dtype=np.float32))
    return out


def pose_meshes(scene: GltfScene, t: float, animation: int = 0):
    """World-space mesh geometry at animation time t.

    Returns [(mesh_index, positions [V,3] world, normals [V,3]|None)] for
    every mesh. Skinned meshes apply the joint palette
    (sum_i w_i * world_j_i @ inverse_bind_i — the glTF skinning equation);
    rigid meshes apply their node's posed transform. The caller feeds the
    positions into the dynamic-geometry refit path (jittable
    build_triangle_geometry, the `optixDynamicGeometry` update role).
    """
    overrides = (sample_animation(scene.animations[animation], t)
                 if scene.animations else {})
    world = node_world_transforms(scene, overrides)

    out = []
    for ni, mesh_ids in scene.node_meshes.items():
        for mi in mesh_ids:
            mesh = scene.meshes[mi]
            base_pos = mesh.positions
            if mesh.targets:
                # morph targets: the "weights" channel targets the NODE;
                # base positions already carry the DEFAULT morph state,
                # so apply (w(t) - default) deltas.
                w_now = overrides.get(ni, {}).get("weights")
                base_nrm = mesh.normals
                if w_now is not None:
                    w_now = np.asarray(w_now, np.float32).reshape(-1)
                    base_pos = base_pos.copy()
                    for t_i, delta in enumerate(mesh.targets):
                        dw = (float(w_now[t_i])
                              - float(mesh.morph_weights[t_i]))
                        if dw != 0.0:
                            base_pos = base_pos + np.float32(dw) * delta
                    if (base_nrm is not None and any(
                            tn is not None for tn in mesh.targets_normal)):
                        # NORMAL morph deltas: accumulate then renormalize
                        # (tinygltf-parity for all morph attributes;
                        # tangents re-derive from morphed positions+uvs).
                        base_nrm = base_nrm.copy()
                        for t_i, dn in enumerate(mesh.targets_normal):
                            if dn is None:
                                continue
                            dw = (float(w_now[t_i])
                                  - float(mesh.morph_weights[t_i]))
                            if dw != 0.0:
                                base_nrm = base_nrm + np.float32(dw) * dn
                        base_nrm = base_nrm / np.maximum(
                            np.linalg.norm(base_nrm, axis=1, keepdims=True),
                            1e-8)
                mesh = type(mesh)(**{**mesh.__dict__,
                                     "positions": base_pos,
                                     "normals": base_nrm})
            if mesh.skin >= 0 and mesh.joints is not None:
                skin = scene.skins[mesh.skin]
                # joint palette [J, 4, 4]
                pal = np.stack([
                    world.get(j, np.eye(4, dtype=np.float32))
                    @ skin.inverse_bind[k]
                    for k, j in enumerate(skin.joints)])
                vm = np.einsum("vj,vjab->vab",
                               mesh.weights,
                               pal[mesh.joints])        # [V, 4, 4]
                p = np.einsum("vab,vb->va",
                              vm[:, :3, :],
                              np.concatenate([mesh.positions,
                                              np.ones((len(mesh.positions),
                                                       1), np.float32)],
                                             axis=1))
                n = None
                if mesh.normals is not None:
                    # normal transform: inverse-transpose of the 3x3 part;
                    # for typical rigid-ish skins the linear part suffices
                    lin = vm[:, :3, :3]
                    inv_t = np.linalg.inv(lin).transpose(0, 2, 1)
                    n = np.einsum("vab,vb->va", inv_t, mesh.normals)
                    n /= np.maximum(np.linalg.norm(n, axis=1,
                                                   keepdims=True), 1e-8)
                out.append((mi, p.astype(np.float32),
                            None if n is None else n.astype(np.float32)))
            else:
                m = world.get(ni, mesh.transform)
                p = mesh.positions @ m[:3, :3].T + m[:3, 3]
                n = None
                if mesh.normals is not None:
                    inv_t = np.linalg.inv(m[:3, :3]).T
                    n = mesh.normals @ inv_t.T
                    n /= np.maximum(np.linalg.norm(n, axis=1,
                                                   keepdims=True), 1e-8)
                out.append((mi, p.astype(np.float32),
                            None if n is None else n.astype(np.float32)))
    return out
