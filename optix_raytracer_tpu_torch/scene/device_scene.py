"""The torch DeviceScene (counterpart of `scene/device_scene.py:32-195,
253-409, 474-575`).

The port's scene holds triangle geometry (with per-corner shading normals,
texture coordinates, tangents and uv densities), per-triangle material ids,
the material table, the custom-prim table (kinds 0-3), the parallelogram
area light, the miss color, the static feature tags (glass, mirror, pbr,
computed from the material dicts as the reference does), the instance table
of a two-level scene, for a flat mesh past the brute-force kernels' 512
triangles the cluster table of the large-mesh traversal, and, for a scene
given textures, the material texture bundles (`pack_bundles`). BVHs,
per-mesh cluster tables of instanced meshes, cutouts, volumes and motion are
not ported yet (ROADMAP.md Queue 1 items 6-9).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..accel import clusters as cluster_mod
from ..accel import native
from ..accel import primitives as prim_mod
from ..accel.geometry import (TriangleGeometry, build_triangle_geometry,
                              uv_frame)
from ..core.vecmath import cross, dot
from ..accel.tlas import InstanceTable, instance_ranges
from ..shade.lights import ParallelogramLight
from ..shade.materials import (GLASS, PBR, TEX_KEYS, MaterialTable,
                               make_material_table)

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
    # Material texture bundles (pack_bundles): [B, H', W', 16] f32 texels
    # and [B, L, 4] int32 (y, x, h, w) per mip level; B = 0 without any.
    bundles: Optional[torch.Tensor] = None
    bundle_mip: Optional[torch.Tensor] = None
    # Static: per bundle the (h, w) of each level, and per material
    # (bundle id, has_base, has_normal, has_mr, has_emissive)
    # (scene/device_scene.py:116-125).
    bundle_meta: tuple = ()
    mat_tex_flags: tuple = ()
    # Images the scene was given (has_textures, device_scene.py:174-176).
    num_textures: int = 0

    def __post_init__(self):
        if self.prims is None:
            self.prims = prim_mod.CustomPrims.empty(self.device)
        if self.instances is None:
            self.instances = InstanceTable.empty(self.device)
        if self.bundles is None:
            self.bundles = torch.zeros((0, 1, 1, 16), dtype=torch.float32,
                                       device=self.device)
            self.bundle_mip = torch.zeros((0, 1, 4), dtype=torch.int32,
                                          device=self.device)

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

    @property
    def has_textures(self) -> bool:
        return self.num_textures > 0

    @functools.cached_property
    def specular_lanes(self) -> bool:
        """Glass or mirror lanes can occur: a glass or mirror material, or a
        PBR material with a metallic-roughness map, which the engine's
        mirror test reads after the map scales metallic and roughness
        (engine.py:378-384, 479-481). Read once per scene (the material
        table does not change)."""
        return self.has_specular or (self.has_textures and bool(
            ((self.materials.kind == PBR) & (self.materials.mr_tex >= 0))
            .any()))

    @functools.cached_property
    def fused_tables(self) -> dict:
        """The fused kernel's packed and checked scene inputs
        (wavefront/pallas_pt.scene_tables), built at the first launch and
        kept: a scene's tensors do not change between launches (a changed
        scene is a new DeviceScene, as dataclasses.replace makes one)."""
        from ..wavefront.pallas_pt import scene_tables
        return scene_tables(self)

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


def _downsample2(img):
    """2x box filter with edge replication on odd dimensions
    (scene/device_scene.py:179-194)."""
    h, w = img.shape[:2]
    if h > 1 and h % 2:
        img = np.concatenate([img, img[-1:]], axis=0)
    if w > 1 and w % 2:
        img = np.concatenate([img, img[:, -1:]], axis=1)
    h2 = max(1, h // 2)
    w2 = max(1, w // 2)
    if h == 1:
        return 0.5 * (img[:, 0::2][:, :w2] + img[:, 1::2][:, :w2])
    if w == 1:
        return 0.5 * (img[0::2][:h2] + img[1::2][:h2])
    return 0.25 * (img[0::2, 0::2][:h2, :w2] + img[1::2, 0::2][:h2, :w2]
                   + img[0::2, 1::2][:h2, :w2] + img[1::2, 1::2][:h2, :w2])


def _resize_bilinear_np(img, h, w):
    """Bilinear resample to (h, w), edges clamped
    (scene/device_scene.py:253-268)."""
    sh, sw = img.shape[:2]
    if (sh, sw) == (h, w):
        return img
    y = (np.arange(h) + 0.5) * sh / h - 0.5
    x = (np.arange(w) + 0.5) * sw / w - 0.5
    y0 = np.clip(np.floor(y).astype(int), 0, sh - 1)
    x0 = np.clip(np.floor(x).astype(int), 0, sw - 1)
    y1 = np.minimum(y0 + 1, sh - 1)
    x1 = np.minimum(x0 + 1, sw - 1)
    fy = np.clip(y - y0, 0, 1)[:, None, None]
    fx = np.clip(x - x0, 0, 1)[None, :, None]
    a = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    b = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    return a * (1 - fy) + b * fy


def _rgba(im):
    """An image as [H, W, 4] f32: uint8 scaled by 1/255, grey repeated to
    RGB, alpha 1 added to RGB."""
    im = np.asarray(im)
    if im.dtype == np.uint8:
        im = im.astype(np.float32) / 255.0
    if im.ndim == 2:
        im = im[..., None].repeat(3, axis=-1)
    if im.shape[-1] == 3:
        im = np.concatenate([im, np.ones_like(im[..., :1])], axis=-1)
    return im.astype(np.float32)


def _mat_tex_ids(m):
    return tuple(int(m.get(k, -1)) for k in TEX_KEYS)


def pack_bundles(images, materials):
    """Material texture bundles (scene/device_scene.py:271-409, without its
    quad rows, a TPU gather device): one 16-channel image per distinct set
    of a material's maps, each map bilinearly resampled to the set's largest
    size and stacked in channels: base RGBA (0:4), normal RGB (4:7),
    emissive RGB (7:10), roughness (10, the mr map's G), metallic (11, its
    B); a missing map leaves white, the flat normal (0.5, 0.5, 1) or 1.
    Each bundle's mip chain (2x box filter down to 1x1) is stored with one
    wrapped border row and column per level, level 0 at (0, 0) and the rest
    stacked in a strip to its right, so a bilinear 2x2 footprint never
    crosses the wrap seam.

    Returns (bundles [B, H', W', 16] f32, bundle_mip [B, L, 4] int32 (y, x,
    h, w) per level, h = w = 0 past a bundle's chain; mat_bundle [K] int32,
    -1 = untextured; meta: per bundle the (h, w) of each level), all numpy
    but meta."""
    imgs = [_rgba(im) for im in images]
    mat_bundle = np.full(len(materials), -1, np.int32)
    keys = {}
    bundles = []
    for k, m in enumerate(materials):
        ids = _mat_tex_ids(m)
        if all(i < 0 for i in ids):
            continue
        if ids in keys:
            mat_bundle[k] = keys[ids]
            continue
        h = max(imgs[i].shape[0] for i in ids if i >= 0)
        w = max(imgs[i].shape[1] for i in ids if i >= 0)
        b = np.zeros((h, w, 16), np.float32)
        b[..., 0:4] = (1.0, 1.0, 1.0, 1.0)
        b[..., 4:7] = (0.5, 0.5, 1.0)
        b[..., 7:12] = 1.0
        bi, ni, mi, ei = ids
        if bi >= 0:
            b[..., 0:4] = _resize_bilinear_np(imgs[bi], h, w)[..., 0:4]
        if ni >= 0:
            b[..., 4:7] = _resize_bilinear_np(imgs[ni], h, w)[..., 0:3]
        if ei >= 0:
            b[..., 7:10] = _resize_bilinear_np(imgs[ei], h, w)[..., 0:3]
        if mi >= 0:
            mr = _resize_bilinear_np(imgs[mi], h, w)
            b[..., 10] = mr[..., 1]         # roughness (G)
            b[..., 11] = mr[..., 2]         # metallic (B)
        keys[ids] = len(bundles)
        mat_bundle[k] = len(bundles)
        bundles.append(b)
    if not bundles:
        return (np.zeros((0, 1, 1, 16), np.float32),
                np.zeros((0, 1, 4), np.int32), mat_bundle, ())

    chains = []
    for b in bundles:
        chain = [b]
        while max(chain[-1].shape[0], chain[-1].shape[1]) > 1:
            chain.append(_downsample2(chain[-1]))
        chains.append(chain)

    def bordered(lv):
        lv = np.concatenate([lv, lv[:1]], axis=0)
        return np.concatenate([lv, lv[:, :1]], axis=1)

    n_levels = max(len(c) for c in chains)
    max_h = max(c[0].shape[0] for c in chains) + 1
    max_w = max(c[0].shape[1] for c in chains) + 1
    strip_w = max((max(lv.shape[1] + 1 for lv in c[1:]) if len(c) > 1
                   else 0) for c in chains)
    strip_h = max(sum(lv.shape[0] + 1 for lv in c[1:]) for c in chains)
    out = np.zeros((len(bundles), max(max_h, strip_h), max_w + strip_w, 16),
                   np.float32)
    mips = np.zeros((len(bundles), n_levels, 4), np.int32)
    for i, chain in enumerate(chains):
        h0, w0 = chain[0].shape[:2]
        out[i, :h0 + 1, :w0 + 1] = bordered(chain[0])
        mips[i, 0] = (0, 0, h0, w0)
        y = 0
        for li, lv in enumerate(chain[1:], start=1):
            hl, wl = lv.shape[:2]
            out[i, y:y + hl + 1, max_w:max_w + wl + 1] = bordered(lv)
            mips[i, li] = (y, max_w, hl, wl)
            y += hl + 1
    meta = tuple(tuple((lv.shape[0], lv.shape[1]) for lv in chain)
                 for chain in chains)
    return out, mips, mat_bundle, meta


def _texture_fields(textures, materials, device) -> dict:
    """The DeviceScene's texture fields from the images and the material
    dicts (scene/device_scene.py:489-515), and the material table's bundle
    plane."""
    textures = list(textures or ())
    if not textures:
        return {}
    bundles, mips, mat_bundle, meta = pack_bundles(textures, materials)
    flags = tuple((int(mat_bundle[k]), *(i >= 0 for i in _mat_tex_ids(m)))
                  for k, m in enumerate(materials))
    return dict(bundles=torch.as_tensor(bundles, device=device),
                bundle_mip=torch.as_tensor(mips, device=device),
                mat_bundle=torch.as_tensor(mat_bundle, device=device),
                bundle_meta=meta, mat_tex_flags=flags,
                num_textures=len(textures))


def make_device_scene(vertices, indices, tri_mat, materials, device,
                      area_light=None, miss_color=(0.0, 0.0, 0.0),
                      normals=None, prims=None, instances=None, uvs=None,
                      textures=()):
    """Triangle mesh + material dicts (+ a CustomPrims table, + an
    InstanceTable over the mesh) → DeviceScene on `device`. normals / uvs:
    optional per-vertex [V, 3] shading normals and [V, 2] texture
    coordinates; textures: images ([H, W, 3 | 4] or [H, W], uint8 or float)
    the materials' texture ids index. An instanced scene gets no cluster
    table."""
    if area_light is None:
        area_light = ParallelogramLight.make(
            (0, 0, 0), (1, 0, 0), (0, 0, 1), (0.0, 0.0, 0.0), device)
    table = make_material_table(materials, device)
    tex = _texture_fields(textures, materials, device)
    if tex:
        table.bundle = tex.pop("mat_bundle")
    geom = build_triangle_geometry(vertices, indices, device, normals=normals,
                                   uvs=uvs)
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
        prims=prims, instances=instances, **tex)


def device_scene_from_numpy(fields, device) -> DeviceScene:
    """Build the port's scene from a JAX DeviceScene's fields, handed over as
    numpy arrays so both sides compute on the same bits. Keys:

      tri_consts [M,16], face_normal [M,3], valid [M], v0 / e1 / e2 [M,3],
      corner_normal [M,3,3], smooth (bool), corner_uv [M,3,2], tangent
      [M,3], uv_density [M]                           (scene.geom)
      tri_mat [M]
      mat_kind, mat_base_color, mat_emission, mat_metallic, mat_roughness,
      mat_ior, mat_kr, mat_base_tex, mat_normal_tex, mat_mr_tex,
      mat_emissive_tex, mat_bundle                      (scene.materials)
      bundles [B,H',W',16], bundle_mip [B,L,4], bundle_meta, mat_tex_flags
      (tuples), num_textures                 (the texture bundles; optional)
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
    instances I = 0. Without the texture keys the geometry's uvs are zero
    (their tangents and densities are derived) and the scene has none.
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
    if "corner_uv" in fields:
        geom.corner_uv = f32("corner_uv")
        geom.tangent, geom.uv_density = f32("tangent"), f32("uv_density")
    else:
        geom.corner_uv = torch.zeros((geom.num_triangles, 3, 2),
                                     dtype=torch.float32, device=device)
        n = cross(geom.e1, geom.e2)
        geom.tangent, geom.uv_density = uv_frame(geom.corner_uv, geom.e1,
                                                 geom.e2, dot(n, n))
    kind = np.asarray(fields["mat_kind"], np.int32)

    def ids(key):
        return (torch.as_tensor(np.asarray(fields[key], np.int32),
                                device=device) if key in fields else None)

    table = MaterialTable(
        kind=torch.as_tensor(kind, device=device),
        base_color=f32("mat_base_color"), emission=f32("mat_emission"),
        metallic=f32("mat_metallic"), roughness=f32("mat_roughness"),
        ior=f32("mat_ior"), kr=f32("mat_kr"),
        **{k: ids(f"mat_{k}") for k in (*TEX_KEYS, "bundle")})
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
    tex = {}
    if int(fields.get("num_textures", 0)):
        tex = dict(bundles=f32("bundles").contiguous(),
                   bundle_mip=torch.as_tensor(
                       np.array(fields["bundle_mip"], np.int32),
                       device=device),
                   bundle_meta=tuple(tuple(tuple(int(x) for x in lv)
                                           for lv in b)
                                     for b in fields["bundle_meta"]),
                   mat_tex_flags=tuple(tuple(f)
                                       for f in fields["mat_tex_flags"]),
                   num_textures=int(fields["num_textures"]))
    return DeviceScene(geom=geom,
                       tri_mat=torch.as_tensor(tri_mat, device=device),
                       materials=table, area_light=light,
                       miss_color=f32("miss_color"),
                       features=tuple(fields.get("features", ())),
                       clusters=clusters, prims=prims, instances=instances,
                       **tex)
