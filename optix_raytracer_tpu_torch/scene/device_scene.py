"""The torch DeviceScene (counterpart of `scene/device_scene.py:32-195,
197-240, 253-470, 474-678`).

The port's scene holds triangle geometry (with per-corner shading normals,
texture coordinates, tangents and uv densities), per-triangle material ids,
the material table, the custom-prim table (kinds 0-3), the parallelogram
area light, the Whitted integrator's light table, the miss color, the
static feature tags (cutouts, glass, mirror, pbr, computed from the material
dicts as the reference does), the instance table of a two-level scene, for a
flat mesh past the brute-force kernels' 512 triangles the cluster table of
the large-mesh traversal, for a scene given textures the texture atlas
(`pack_textures`) and the material texture bundles (`pack_bundles`), and
for a scene with alpha cutouts its opacity micromaps: per triangle the
micro-triangle states and the summary, and the occlusion split they give (the
certain-solid triangles, with their own cluster table past 512, and the
unknown ones), for a scene given moving triangles their two vertex keys and
materials (`accel/motion.py`, traced at per-path shutter times), and for a
scene given a fog volume its density grid with sigma_t and albedo
(`accel/volume.py`), and with `with_bvh` (or a `bvh` handed in, as
`api/pipeline.py` hands a GAS's) the threaded BVH that a mesh past the
cluster tier's cap walks (`accel/traverse.py`), and for an instanced mesh past 512 triangles its
own object-space cluster table (`instance_clusters`,
device_scene.py:543-556).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from .. import telemetry
from ..accel import clusters as cluster_mod
from ..accel import micromap as mm
from ..accel import native
from ..accel.lbvh import LBVH, build_lbvh
from ..accel.motion import MotionTriangles
from ..accel.volume import DensityGrid
from ..accel import primitives as prim_mod
from ..accel.geometry import (TriangleGeometry, build_triangle_geometry,
                              select_geometry, uv_frame)
from ..core.vecmath import cross, dot
from ..accel.tlas import InstanceTable, instance_ranges, slice_geometry
from ..accel.tri_groups import bf_group_boxes
from ..shade.lights import LightTable, ParallelogramLight
from ..shade.materials import (ALPHA_MASK, CUT_CHECKER, CUT_CIRCLE,
                               CUT_TEXTURE, GLASS, PBR, TEX_KEYS,
                               WHITTED_DEFAULTS, MaterialTable,
                               make_material_table)

# The feature tags of the JAX DeviceScene (device_scene.py:550-577); the
# port renders them all.
FEATURES = frozenset({"cutouts", "glass", "mirror", "pbr", "volume"})
# A scene given a pre-built MaterialTable (the pipeline's SBT) assumes
# every material family is possible, as the reference's does
# (device_scene.py:578-580): its engine then draws every lane's RNG pairs.
PREBUILT_FEATURES = ("glass", "mirror", "pbr")

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
    lights: LightTable                  # the Whitted integrator's lights
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
    # The texture atlas (pack_textures): [T, H', W', 4] f32 texels, [T, 2]
    # int32 level-0 (h, w) and [T, L, 4] int32 (y, x, h, w) per level; T =
    # 0 without textures. The Whitted lane and the any-hit cutout mask
    # read level 0 (shade/texture.py::sample_bilinear).
    textures: Optional[torch.Tensor] = None
    tex_size: Optional[torch.Tensor] = None
    tex_mip: Optional[torch.Tensor] = None
    # Opacity micromaps (device_scene.py:85-112): [M, 4^level] uint8
    # micro-triangle states and the [M] uint8 summary (accel/micromap.py),
    # None without cutouts or with micromaps off; the occlusion split: the
    # certain-solid triangles (summary OPAQUE, every non-cutout triangle),
    # with a cluster table past MAX_SMEM_TRIS of them, and the unknown ones
    # with their scene row ids. Summary-transparent triangles are in
    # neither: they never block light.
    omm_micro: Optional[torch.Tensor] = None
    omm_summary: Optional[torch.Tensor] = None
    omm_level: int = 0
    omm_solid_geom: Optional[TriangleGeometry] = None
    omm_unknown_geom: Optional[TriangleGeometry] = None
    omm_unknown_ids: Optional[torch.Tensor] = None
    omm_solid_clusters: Optional[cluster_mod.ClusterSet] = None
    # Moving triangles (device_scene.py:59-64): two vertex keys, traced at
    # each path's shutter time, and their [Mm] int32 material ids; empty
    # without motion.
    motion_geom: Optional[MotionTriangles] = None
    motion_tri_mat: Optional[torch.Tensor] = None
    # A fog volume (device_scene.py:52-58): the density grid and [2] f32
    # (sigma_t, albedo); the grid is read only with the "volume" feature.
    volume: Optional[DensityGrid] = None
    volume_params: Optional[torch.Tensor] = None
    # The threaded BVH (device_scene.py:44, 519-526), None without one: a
    # mesh past MAX_SMEM_TRIS triangles with no cluster table walks it.
    bvh: Optional[LBVH] = None
    # Per-mesh object-space cluster tables of a two-level scene
    # (device_scene.py:543-556): {(lo, hi): ClusterSet} for each distinct
    # instance range past MAX_SMEM_TRIS triangles and within
    # MAX_STREAM_CLUSTERS clusters; its instances walk it (kernels 4-6),
    # the others take kernels 1-2 on their slice.
    instance_clusters: Optional[dict] = None

    def __post_init__(self):
        if self.prims is None:
            self.prims = prim_mod.CustomPrims.empty(self.device)
        if self.instances is None:
            self.instances = InstanceTable.empty(self.device)
        if self.instance_clusters is None:
            self.instance_clusters = {}
        if self.bundles is None:
            self.bundles = torch.zeros((0, 1, 1, 16), dtype=torch.float32,
                                       device=self.device)
            self.bundle_mip = torch.zeros((0, 1, 4), dtype=torch.int32,
                                          device=self.device)
        if self.motion_geom is None:
            self.motion_geom = MotionTriangles.empty(self.device)
            self.motion_tri_mat = torch.zeros((0,), dtype=torch.int32,
                                              device=self.device)
        if self.volume is None:
            self.volume = DensityGrid.empty(self.device)
        if self.volume_params is None:
            self.volume_params = torch.tensor([8.0, 0.9],
                                              dtype=torch.float32,
                                              device=self.device)
        if self.textures is None:
            self.textures = torch.zeros((0, 1, 1, 4), dtype=torch.float32,
                                        device=self.device)
            self.tex_size = torch.zeros((0, 2), dtype=torch.int32,
                                        device=self.device)
            self.tex_mip = torch.zeros((0, 1, 4), dtype=torch.int32,
                                       device=self.device)

    @property
    def num_triangles(self):
        return self.geom.num_triangles

    @property
    def has_clusters(self) -> bool:
        return self.clusters is not None and self.clusters.num_clusters > 0

    @property
    def has_bvh(self) -> bool:
        return self.bvh is not None and self.bvh.num_nodes > 0

    @property
    def has_instances(self) -> bool:
        return self.instances.num > 0

    @property
    def device(self):
        return self.geom.tri_consts.device

    @property
    def has_motion(self) -> bool:
        """Moving triangles: each path draws a shutter time first
        (engine.py:212-217), and every query folds them in."""
        return self.motion_geom.num_triangles > 0

    @property
    def has_volume(self) -> bool:
        """A fog volume: each bounce samples a scatter point and NEE takes
        the transmittance (engine.py:122-129, 253-294)."""
        return "volume" in self.features

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

    @property
    def has_cutouts(self) -> bool:
        """A material is an alpha cutout: hits go through the mask, on
        radiance and occlusion rays."""
        return "cutouts" in self.features

    @property
    def has_omm(self) -> bool:
        return self.omm_summary is not None and self.omm_summary.shape[0] > 0

    @property
    def omm_all_certain(self) -> bool:
        """Every triangle's summary is certain: the micromaps decide every
        pass-through, and no mask is evaluated (device_scene.py:152-158)."""
        return self.has_omm and self.omm_unknown_ids.shape[0] == 0

    @functools.cached_property
    def omm_boxes(self) -> tuple:
        """Kernels 1-2's group boxes of the solid and the unknown split
        (bf_group_boxes; None below FUSED_CULL_MIN_TRIS triangles), built
        once, at the first occlusion query."""
        return (bf_group_boxes(self.omm_solid_geom),
                bf_group_boxes(self.omm_unknown_geom))

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
        scene is a new DeviceScene, as dataclasses.replace makes one); the
        build is the `scene.fused_tables` span."""
        from ..wavefront.pallas_pt import scene_tables
        with telemetry.span("scene.fused_tables"):
            return scene_tables(self)

    @functools.cached_property
    def fused_plans(self) -> dict:
        """The fused kernel's launch plans by launch shape
        (wavefront/pallas_pt.fused_plan fills it, at most MAX_FUSED_PLANS):
        built at a shape's first launch and kept, as fused_tables is."""
        return {}

    @functools.cached_property
    def launch_graphs(self) -> dict:
        """The sequential cluster loop's launches as CUDA graphs, by launch
        shape (wavefront/launch_graph.run fills it, at most
        MAX_LAUNCH_GRAPHS), kept as fused_plans are."""
        return {}

    @functools.cached_property
    def fused_fits(self) -> bool:
        """Whether the scene's content lets "auto" take the fused kernel
        (wavefront/engine._fused_fits), read once; engine._use_fused adds
        the device test."""
        from ..wavefront.engine import _fused_fits
        return _fused_fits(self)

    @functools.cached_property
    def bf_boxes(self) -> tuple:
        """Kernels 1-2's group boxes (accel/tri_groups.bf_group_boxes), one
        entry per instance range (one for the whole table without
        instances), None for a range below FUSED_CULL_MIN_TRIS triangles
        or with its own cluster table:
        built once, at the first brute-force query or fused launch (the
        fused kernel's box cache holds the flat entry, scene_tables)."""
        if not self.has_instances:
            return (bf_group_boxes(self.geom),)
        made = {}
        for rng in instance_ranges(self.instances, self.num_triangles):
            if rng not in made:
                made[rng] = (None if rng in self.instance_clusters
                             else bf_group_boxes(
                                 slice_geometry(self.geom, *rng)))
        return tuple(made[rng] for rng in instance_ranges(
            self.instances, self.num_triangles))

    def require_supported(self):
        """Raise for a prim kind or a feature tag the port does not know."""
        prim_mod.require_ported(self.prims)
        unknown = sorted(set(self.features) - FEATURES)
        if unknown:
            raise ValueError(f"unknown scene features {unknown}")


def _check_tri_mat(tri_mat, num_tris, num_mats):
    tri_mat = np.asarray(tri_mat, np.int32).reshape(-1)
    if tri_mat.shape[0] != num_tris:
        raise ValueError(f"tri_mat has {tri_mat.shape[0]} entries for "
                         f"{num_tris} triangles")
    if tri_mat.size and (tri_mat.min() < 0 or tri_mat.max() >= num_mats):
        raise ValueError(f"material ids must lie in [0, {num_mats})")
    return tri_mat


def _check_instances(instances: InstanceTable, tri_mat, num_tris, num_mats):
    """Each range inside the geometry, and each hit's material id, tri_mat +
    sbt_offset, inside the table."""
    sbt = instances.sbt_offset.cpu().numpy()
    for i, (lo, hi) in enumerate(instance_ranges(instances, num_tris)):
        if not 0 <= lo <= hi <= num_tris:
            raise ValueError(f"instance {i}: range ({lo}, {hi}) outside the "
                             f"{num_tris} triangles")
        ids = tri_mat[lo:hi] + sbt[i]
        if ids.size and (ids.min() < 0 or ids.max() >= num_mats):
            raise ValueError(f"instance {i}: material ids with its sbt "
                             f"offset must lie in [0, {num_mats})")


def _build_instance_clusters(geom: TriangleGeometry, tri_mat: torch.Tensor,
                             instances: Optional[InstanceTable]) -> dict:
    """{(lo, hi): ClusterSet} of a two-level scene (device_scene.py:
    543-556): for each distinct instance range of more than MAX_SMEM_TRIS
    triangles and at most MAX_STREAM_CLUSTERS clusters, the cluster table
    of its slice in object space, in SAH leaf order (morton without the
    native builder). Its hits report slice-local triangle ids and tri_mat
    rows; a larger range stays on brute force, as in the reference."""
    if instances is None:
        return {}
    out = {}
    for lo, hi in sorted(set(instance_ranges(instances,
                                             geom.num_triangles))):
        m = hi - lo
        if m > MAX_SMEM_TRIS and (-(-m // cluster_mod.LANES)
                                  <= cluster_mod.MAX_STREAM_CLUSTERS):
            sub = slice_geometry(geom, lo, hi)
            out[(lo, hi)] = cluster_mod.build_clusters(
                sub, tri_mat[lo:hi], order=native.sah_leaf_order(sub))
    return out


def _build_cluster_table(geom: TriangleGeometry, tri_mat: torch.Tensor):
    """The cluster table of a mesh past MAX_SMEM_TRIS triangles, up to the
    supercluster tier's MAX_SUPERCLUSTERS * SC_CLUSTERS clusters (4.19M
    triangles), in SAH leaf order, or morton order without the native
    builder (scene/device_scene.py:533-542); None for a smaller mesh and
    past the cap, where a scene with a BVH walks it and one without takes
    brute force (intersect.py:129-131)."""
    n = geom.num_triangles
    cap = cluster_mod.MAX_SUPERCLUSTERS * cluster_mod.SC_CLUSTERS
    if n <= MAX_SMEM_TRIS or -(-n // cluster_mod.LANES) > cap:
        return None
    return cluster_mod.build_clusters(geom, tri_mat,
                                      order=native.sah_leaf_order(geom))


def build_scene_bvh(geom: TriangleGeometry) -> LBVH:
    """The scene's BVH (device_scene.py:519-526): the native SAH build
    (better trees for static scenes) where the builder is available, else
    the LBVH built on the geometry's device."""
    arrays = native.build_bvh_sah(geom)
    if arrays is None:
        return build_lbvh(geom)
    return LBVH.from_numpy(arrays, geom.tri_consts.device)


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


def pack_textures(images):
    """Images → the mip atlas (scene/device_scene.py:197-240): one dense
    [T, H', W', 4] f32 atlas, each texture's level 0 at (0, 0) and its
    levels 1+ (2x box filter down to 1x1) stacked in a strip to the right
    of the widest level 0. → (textures, tex_size [T, 2] int32 level-0 (h,
    w), tex_mip [T, L, 4] int32 (y, x, h, w) per level, h = w = 0 past a
    texture's chain), numpy."""
    if not images:
        return (np.zeros((0, 1, 1, 4), np.float32),
                np.zeros((0, 2), np.int32), np.zeros((0, 1, 4), np.int32))
    chains = []
    for im in images:
        chain = [_rgba(im)]
        while max(chain[-1].shape[0], chain[-1].shape[1]) > 1:
            chain.append(_downsample2(chain[-1]))
        chains.append(chain)
    n_levels = max(len(c) for c in chains)
    max_h = max(c[0].shape[0] for c in chains)
    max_w = max(c[0].shape[1] for c in chains)
    strip_w = max(max(lv.shape[1] for lv in c[1:]) if len(c) > 1 else 0
                  for c in chains)
    strip_h = max(sum(lv.shape[0] for lv in c[1:]) for c in chains)
    out = np.zeros((len(images), max(max_h, strip_h), max_w + strip_w, 4),
                   np.float32)
    sizes = np.zeros((len(images), 2), np.int32)
    mips = np.zeros((len(images), n_levels, 4), np.int32)
    for i, chain in enumerate(chains):
        h0, w0 = chain[0].shape[:2]
        out[i, :h0, :w0] = chain[0]
        sizes[i] = (h0, w0)
        mips[i, 0] = (0, 0, h0, w0)
        y = 0
        for li, lv in enumerate(chain[1:], start=1):
            hl, wl = lv.shape[:2]
            out[i, y:y + hl, max_w:max_w + wl] = lv
            mips[i, li] = (y, max_w, hl, wl)
            y += hl
    return out, sizes, mips


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
    dicts (scene/device_scene.py:484-515): the atlas, the bundles, and the
    material table's bundle plane; the atlas alone without the dicts (a
    pre-built MaterialTable, device_scene.py:488-489)."""
    textures = list(textures or ())
    if not textures:
        return {}
    atlas, sizes, tex_mips = pack_textures(textures)
    if materials is None:
        return dict(textures=torch.as_tensor(atlas, device=device),
                    tex_size=torch.as_tensor(sizes, device=device),
                    tex_mip=torch.as_tensor(tex_mips, device=device),
                    num_textures=len(textures))
    bundles, mips, mat_bundle, meta = pack_bundles(textures, materials)
    flags = tuple((int(mat_bundle[k]), *(i >= 0 for i in _mat_tex_ids(m)))
                  for k, m in enumerate(materials))
    return dict(textures=torch.as_tensor(atlas, device=device),
                tex_size=torch.as_tensor(sizes, device=device),
                tex_mip=torch.as_tensor(tex_mips, device=device),
                bundles=torch.as_tensor(bundles, device=device),
                bundle_mip=torch.as_tensor(mips, device=device),
                mat_bundle=torch.as_tensor(mat_bundle, device=device),
                bundle_meta=meta, mat_tex_flags=flags,
                num_textures=len(textures))


def _is_cut(m) -> bool:
    return bool(m.get("cutout", 0)) or m.get("alpha_mode", 0) == ALPHA_MASK


def build_scene_omm(materials, tri_mat, corner_uv, textures, level):
    """Opacity micromaps of every cutout-material triangle
    (scene/device_scene.py:412-470): per ALPHA_MASK material its mask, the
    checker or circle at its checker_scale, or for CUT_TEXTURE the base
    map's level-0 alpha at the nearest texel (wrapped) against its
    alpha_cutoff, sampled conservatively (accel/micromap.py); a mask
    material with no mask function, and every other triangle, is OPAQUE.
    tri_mat [M] and corner_uv [M, 3, 2] numpy, textures the raw images. →
    (micro_states [M, 4^level] uint8, summary [M] uint8)."""
    m_tris = int(tri_mat.shape[0])
    states = np.full((m_tris, 4 ** level), mm.OPAQUE, np.uint8)
    summary = np.full((m_tris,), mm.OPAQUE, np.uint8)

    def tex_alpha_mask(tex_id, cutoff):
        img = np.asarray(textures[tex_id])
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        alpha = (img[..., 3] if img.ndim == 3 and img.shape[-1] == 4
                 else np.ones(img.shape[:2], np.float32))

        def fn(uv):
            h, w = alpha.shape
            x = np.floor((uv[:, 0] % 1.0) * w).astype(np.int64) % w
            y = np.floor((uv[:, 1] % 1.0) * h).astype(np.int64) % h
            return alpha[y, x] < cutoff
        return fn

    for k, mdef in enumerate(materials):
        if mdef.get("alpha_mode", 0) != ALPHA_MASK:
            continue
        kind = mdef.get("cutout", 0)
        scale = float(mdef.get("checker_scale", 1.0))
        if kind == CUT_CHECKER:
            fn = mm.checker_mask(scale)
        elif kind == CUT_CIRCLE:
            fn = mm.circle_mask(scale)
        elif (kind == CUT_TEXTURE and len(textures)
                and int(mdef.get("base_tex", -1)) >= 0):
            fn = tex_alpha_mask(int(mdef["base_tex"]),
                                float(mdef.get("alpha_cutoff", 0.5)))
        else:
            continue
        sel = np.nonzero(tri_mat == k)[0]
        if not len(sel):
            continue
        st, su = mm.build_opacity_micromap(corner_uv[sel], fn, level=level)
        states[sel] = st
        summary[sel] = su
    return states, summary


def _omm_fields(geom: TriangleGeometry, tri_mat: torch.Tensor, states,
                summary, level: int) -> dict:
    """The DeviceScene's micromap fields from the states and summary (numpy)
    (scene/device_scene.py:616-640): the certain-solid rows (summary
    OPAQUE) and the unknown rows of the scene geometry, and past
    MAX_SMEM_TRIS solid triangles, up to the supercluster tier's cap, the
    solid split's cluster table in SAH order."""
    dev = geom.tri_consts.device
    solid = summary == mm.OPAQUE
    unknown = (summary != mm.OPAQUE) & (summary != mm.TRANSPARENT)
    solid_rows = torch.as_tensor(np.nonzero(solid)[0], dtype=torch.int64,
                                 device=dev)
    unknown_rows = torch.as_tensor(np.nonzero(unknown)[0], dtype=torch.int64,
                                   device=dev)
    solid_geom = select_geometry(geom, solid_rows)
    n_solid = solid_geom.num_triangles
    clusters = None
    if (n_solid > MAX_SMEM_TRIS and -(-n_solid // cluster_mod.LANES)
            <= cluster_mod.MAX_SUPERCLUSTERS * cluster_mod.SC_CLUSTERS):
        clusters = cluster_mod.build_clusters(
            solid_geom, tri_mat[solid_rows],
            order=native.sah_leaf_order(solid_geom))
    return dict(omm_micro=torch.as_tensor(states, device=dev),
                omm_summary=torch.as_tensor(summary, device=dev),
                omm_level=int(level), omm_solid_geom=solid_geom,
                omm_unknown_geom=select_geometry(geom, unknown_rows),
                omm_unknown_ids=unknown_rows.to(torch.int32),
                omm_solid_clusters=clusters)


def make_device_scene(vertices, indices, tri_mat, materials, device,
                      area_light=None, miss_color=(0.0, 0.0, 0.0),
                      normals=None, prims=None, instances=None, uvs=None,
                      textures=(), lights=(), opacity_micromaps=True,
                      omm_level=3, motion=None,
                      volume: Optional[DensityGrid] = None,
                      volume_sigma: float = 8.0, volume_albedo: float = 0.9,
                      with_bvh: bool = False):
    """Triangle mesh + material dicts (+ a CustomPrims table, + an
    InstanceTable over the mesh) → DeviceScene on `device`. materials may
    also be a pre-built MaterialTable on `device`: the scene then takes
    PREBUILT_FEATURES, packs no texture bundles and builds no micromaps,
    as the reference does. lights: the
    Whitted integrator's light dicts (LightTable.make). normals / uvs:
    optional per-vertex [V, 3] shading normals and [V, 2] texture
    coordinates; textures: images ([H, W, 3 | 4] or [H, W], uint8 or float)
    the materials' texture ids index. An instanced scene gets no scene
    cluster table; each of its ranges past MAX_SMEM_TRIS triangles gets
    its own (`_build_instance_clusters`). A scene with cutout materials gets opacity micromaps at
    `omm_level` unless opacity_micromaps is False, it is instanced, or a
    custom prim's or a moving triangle's material is a cutout (the
    micromap occlusion answers prims and moving triangles with one any-hit
    query, device_scene.py:578-603). motion: dict(verts0, verts1, indices,
    tri_mat=0 (an int or one id per triangle)), triangles moving between
    two vertex keys, traced at per-path shutter times. volume: a
    DensityGrid (on `device`) of a fog volume with extinction volume_sigma
    and single-scattering albedo volume_albedo (device_scene.py:480-485,
    576-577, 643-656). with_bvh: build the scene's BVH (build_scene_bvh),
    which a mesh past MAX_SMEM_TRIS triangles walks where it has no cluster
    table (past the cluster tier's cap). The call is the `scene.upload`
    span."""
    with telemetry.span("scene.upload"):
        if area_light is None:
            area_light = ParallelogramLight.make(
                (0, 0, 0), (1, 0, 0), (0, 0, 1), (0.0, 0.0, 0.0), device)
        prebuilt = isinstance(materials, MaterialTable)
        table = (materials if prebuilt
                 else make_material_table(materials, device))
        tex = _texture_fields(textures, None if prebuilt else materials,
                              device)
        if "mat_bundle" in tex:
            table.bundle = tex.pop("mat_bundle")
        geom = build_triangle_geometry(vertices, indices, device,
                                       normals=normals, uvs=uvs)
        tri_mat_np = _check_tri_mat(tri_mat, geom.num_triangles, table.num)
        tri_mat = torch.as_tensor(tri_mat_np, device=device)
        if instances is not None:
            _check_instances(instances, tri_mat_np, geom.num_triangles,
                             table.num)
        if prims is not None and prims.num and (
                int(prims.mat_id.min()) < 0
                or int(prims.mat_id.max()) >= table.num):
            raise ValueError(f"prim material ids must lie in [0, {table.num})")
        features = (PREBUILT_FEATURES if prebuilt
                    else material_features(materials))
        omm = {}
        if volume is not None:
            features = features + ("volume",)
        mgeom, mmat = None, None
        if motion is not None:
            mgeom = MotionTriangles.make(motion["verts0"], motion["verts1"],
                                         motion["indices"], device)
            mt = np.asarray(motion.get("tri_mat", 0), np.int32)
            mmat = torch.as_tensor(np.broadcast_to(mt, (mgeom.num_triangles,))
                                   .copy(), device=device)
            if mgeom.num_triangles and (int(mmat.min()) < 0
                                        or int(mmat.max()) >= table.num):
                raise ValueError(f"motion material ids must lie in "
                                 f"[0, {table.num})")
        # The micromap occlusion answers prims and moving triangles with plain
        # any-hit queries: exact only while none of their materials is a cutout
        # (device_scene.py:581-603).
        aux_mats = []
        if prims is not None and prims.num:
            aux_mats += prims.mat_id.cpu().tolist()
        if mmat is not None:
            aux_mats += mmat.cpu().tolist()
        aux_cut = not prebuilt and any(_is_cut(materials[int(i)])
                                       for i in aux_mats)
        if (opacity_micromaps and "cutouts" in features and instances is None
                and not aux_cut):
            states, summary = build_scene_omm(
                materials, tri_mat_np, geom.corner_uv.cpu().numpy(),
                list(textures or ()), omm_level)
            omm = _omm_fields(geom, tri_mat, states, summary, omm_level)
        return DeviceScene(
            geom=geom, tri_mat=tri_mat, materials=table, area_light=area_light,
            miss_color=torch.as_tensor(miss_color, dtype=torch.float32,
                                       device=device),
            features=features,
            clusters=(None if instances is not None
                      else _build_cluster_table(geom, tri_mat)),
            instance_clusters=_build_instance_clusters(geom, tri_mat,
                                                       instances),
            prims=prims, instances=instances,
            lights=LightTable.make(list(lights), device),
            motion_geom=mgeom, motion_tri_mat=mmat, volume=volume,
            volume_params=torch.tensor([volume_sigma, volume_albedo],
                                       dtype=torch.float32, device=device),
            bvh=build_scene_bvh(geom) if with_bvh else None,
            **tex, **omm)


def device_scene_from_numpy(fields, device) -> DeviceScene:
    """Build the port's scene from a JAX DeviceScene's fields, handed over as
    numpy arrays so both sides compute on the same bits. Keys:

      tri_consts [M,16], face_normal [M,3], valid [M], v0 / e1 / e2 [M,3],
      corner_normal [M,3,3], smooth (bool), corner_uv [M,3,2], tangent
      [M,3], uv_density [M]                           (scene.geom)
      tri_mat [M]
      mat_kind, mat_base_color, mat_emission, mat_metallic, mat_roughness,
      mat_ior, mat_kr, mat_base_tex, mat_normal_tex, mat_mr_tex,
      mat_emissive_tex, mat_bundle, mat_specular, mat_phong_exp,
      mat_checker1, mat_checker_scale, mat_alpha_mode, mat_cutout,
      mat_alpha_cutoff (the last three optional)       (scene.materials)
      bundles [B,H',W',16], bundle_mip [B,L,4], bundle_meta, mat_tex_flags
      (tuples), num_textures, textures [T,H',W',4], tex_size [T,2],
      tex_mip [T,L,4]             (the texture bundles and atlas; optional)
      omm_micro [M,4^level], omm_summary [M], omm_level
                          (the opacity micromaps; optional, M may be 0)
      light_corner, light_v1, light_v2, light_normal, light_emission
      lights_kind [L], lights_position [L,3], lights_color [L,3],
      lights_falloff [L], lights_radius [L]                (scene.lights)
      miss_color [3]
      features (tuple of str)
      prim_kind [P], prim_params [P,18], prim_mat_id [P]  (scene.prims;
                                                       optional, P may be 0)
      num_clusters, cluster_comp [C,32,128], cluster_aabb [C_rows,6,128],
      cluster_slot_prim [C*128]                       (scene.clusters)
      inst_transform, inst_inv_transform [I,3,4], inst_sbt_offset,
      inst_instance_id [I], inst_prim_ranges (tuple of (lo, hi)),
      inst_row_ids (bool)                  (scene.instances; optional)
      motion_v0_0, motion_e1_0, motion_e2_0, motion_v0_1, motion_e1_1,
      motion_e2_1 [Mm,3], motion_tri_mat [Mm]
                                 (scene.motion_geom; optional, Mm may be 0)
      volume_density [D,H,W], volume_lo [3], volume_hi [3],
      volume_params [2]                        (scene.volume; optional)

    A scene without a cluster table has num_clusters 0, one without
    instances I = 0. Without the texture keys the geometry's uvs are zero
    (their tangents and densities are derived) and the scene has none.
    """
    def f32(key):
        return torch.as_tensor(np.array(fields[key], np.float32),
                               device=device)

    def i32(key):
        return torch.as_tensor(np.asarray(fields[key], np.int32),
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
        return i32(key) if key in fields else None

    table = MaterialTable(
        kind=torch.as_tensor(kind, device=device),
        base_color=f32("mat_base_color"), emission=f32("mat_emission"),
        metallic=f32("mat_metallic"), roughness=f32("mat_roughness"),
        ior=f32("mat_ior"), kr=f32("mat_kr"),
        **{k: f32(f"mat_{k}") for k in WHITTED_DEFAULTS},
        **{k: ids(f"mat_{k}") for k in (*TEX_KEYS, "bundle", "alpha_mode",
                                        "cutout")},
        alpha_cutoff=(f32("mat_alpha_cutoff") if "mat_alpha_cutoff" in fields
                      else None))
    lights = LightTable(kind=i32("lights_kind"),
                        position=f32("lights_position"),
                        color=f32("lights_color"),
                        falloff=i32("lights_falloff"),
                        radius=f32("lights_radius"))
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
        if "textures" in fields:
            tex.update(textures=f32("textures").contiguous(),
                       tex_size=i32("tex_size"), tex_mip=i32("tex_mip"))
    tri_mat = torch.as_tensor(tri_mat, device=device)
    omm = {}
    if len(fields.get("omm_summary", ())):
        omm = _omm_fields(geom, tri_mat,
                          np.asarray(fields["omm_micro"], np.uint8),
                          np.asarray(fields["omm_summary"], np.uint8),
                          int(fields["omm_level"]))
    extra = {}
    if len(fields.get("motion_tri_mat", ())):
        extra.update(
            motion_geom=MotionTriangles(**{
                k: f32(f"motion_{k}") for k in ("v0_0", "e1_0", "e2_0",
                                                "v0_1", "e1_1", "e2_1")}),
            motion_tri_mat=i32("motion_tri_mat"))
    if "volume_density" in fields:
        extra.update(volume=DensityGrid(
            density=f32("volume_density").contiguous(),
            lo=f32("volume_lo"), hi=f32("volume_hi")),
            volume_params=f32("volume_params"))
    return DeviceScene(geom=geom, tri_mat=tri_mat,
                       materials=table, area_light=light,
                       miss_color=f32("miss_color"),
                       features=tuple(fields.get("features", ())),
                       clusters=clusters, prims=prims, instances=instances,
                       instance_clusters=_build_instance_clusters(
                           geom, tri_mat, instances),
                       lights=lights, **tex, **omm, **extra)
