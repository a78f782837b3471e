"""The fused path-trace kernel (kernel 3 and its variants 3') and its plain
version (counterpart of `wavefront/pallas_pt.py:206-391, 398-1378,
1392-1495`; the kernel is `csrc/pt_fused.cuh`, instantiated by
`csrc/pt_fused.cu`, `pt_fused_inst.cu`, `pt_fused_smooth.cu` and
`pt_fused_tex.cu`).

`render_sum_fused` renders `samples_per_launch` progressive samples of a row
tile in one launch and returns their radiance SUM and the rays traced. On
CUDA tensors it launches the kernel; on CPU tensors it runs the plain
version, the wavefront engine's `render_sample` loop over the same
subframes, which is the relation the JAX package keeps between
`engine.render_sample` and its megakernel.

The kernel is a template over a geometry mode and the TPU kernel's static
flags <specular, pbr, prims>: `specular_lanes` (glass or mirror materials,
or a PBR material whose metallic-roughness map can make a mirror lane),
`has_pbr` (rough metallic-roughness lanes) and the inline custom prims (at
most MAX_FUSED_PRIMS of FUSED_PRIM_KINDS). The geometry mode is "flat", "inst"
(`inst_ranges`: at most MAX_FUSED_INST instances over the shared triangles,
each ray moved into each instance's object space), "smooth" (the winner's
corner normals interpolated, as the engine's shading-frame epilogue does) or
"tex" (the TPU kernel's `tex_cfg`: the smooth mode's interpolation on every
triangle hit, flat meshes included, and the texture unit: the winner's uv,
tangent and uv density, the bundle fetch at the ray cone's mip level and the
four maps, as the engine's texture lanes do); instances meet neither smooth
normals nor textures (pallas_pt.py:1430-1432), so 4 x 8 instantiations
exist. <flat, false, false, false> is the Cornell configuration. Each
instantiation counts its launches under its own `kernels.LAUNCHES` key
(`kernels.pt_fused_name`).

Outside instances the kernel culls the triangle table by groups of
`fused_group_size` consecutive triangles: a ray tests a group only when its
slab test crosses the group's box widened by the walks' admission margin
(`tri_groups.fused_group_boxes`, `fused_group_admitted_plain`). The torch
emulations of the culled loops (`fused_group_closest_plain`,
`fused_group_any_plain`) give brute force's ids and occlusion and count the
tests.

A launch on the card takes the plan of its scene and launch shape
(`fused_plan`, kept on the DeviceScene): whatever depends on those alone
is worked out at the shape's first launch, so a launch packs its camera
block on the device (the ortho flag's cast and one `cat`) and makes the
library call, with no host-to-device copy and no sync.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels, telemetry
from ..accel.pallas_bf import _group_walk
from ..accel.tlas import instance_ranges
# Group culling (fused_group_size), outside instances: a table of at least
# FUSED_CULL_MIN_TRIS triangles is cut into groups of FUSED_GROUP
# consecutive triangles; a smaller table is tested whole, without a box
# (the group rule lives in accel/tri_groups.py, shared with kernels 1-2).
from ..accel.tri_groups import (BOX_COLS, FUSED_CULL_MIN_TRIS, FUSED_GROUP,
                                fused_group_boxes)
from ..scene.device_scene import DeviceScene
# The plain version of kernel 3 is the wavefront engine's sample loop (on
# CUDA tensors its intersections come from kernels 1 and 2).
from .engine import pixel_spread
from .engine import render_sum_wavefront as render_sum_plain

# kind, base3, emission3, metallic, ior, kr3, roughness; on a textured
# scene the bundle id, the map flags with the chain length and the level-0
# size (pack_materials)
MAT_COLS = 16
# Triangles + materials + prims are staged in shared memory: (512 + 128 +
# 16) rows of 64 bytes stay under the 48 KB a block gets without opting in
# to more.
MAX_FUSED_TRIS = 512
MAX_FUSED_MATS = 128
MAX_FUSED_PRIMS = 16
FUSED_PRIM_KINDS = (0, 1, 2, 3)     # sphere, shell, parallelogram, capsule
# Scene features the kernel renders (engine._use_fused).
FUSED_FEATURES = frozenset({"glass", "mirror", "pbr"})
# Instances in the instance variant: their [I, 16] rows and [I, 2] ranges
# add 2.3 KB of shared memory at this cap.
MAX_FUSED_INST = 32
# kernels.GEOMETRY codes of the kernel's geometry modes.
FLAT, INST, SMOOTH, TEX = "flat", "inst", "smooth", "tex"
# Map flag bits of a material row's column 14 (pack_materials); the chain
# length of its bundle sits above them.
TEX_BASE, TEX_NORMAL, TEX_MR, TEX_EMISSIVE, TEX_CHAIN_SHIFT = 1, 2, 4, 8, 4
# Columns of the texture variant's per-triangle plane (pack_tex_attrs).
TEX_ATTR_COLS = 20
# Launch plans a scene keeps (DeviceScene.fused_plans, fused_plan): one a
# launch shape, such as a viewer's sizes or a frame's row tiles.
MAX_FUSED_PLANS = 8
# Fused launches that built their plan and that reused one.
PLANS = telemetry.counters("fused.plans", ("built", "reused"))


def pack_materials(mt, bundle_mip=None) -> torch.Tensor:
    """MaterialTable → [K, 16] f32 rows. With `bundle_mip` (a textured
    scene) columns 13-15 carry the material's bundle id (-1 = none), its
    map flags (TEX_BASE | TEX_NORMAL | TEX_MR | TEX_EMISSIVE) plus its
    bundle's mip chain length << TEX_CHAIN_SHIFT, and its bundle's level-0
    size max(h, w): the TPU kernel's static `tex_cfg` tables
    (pallas_pt.py:358-368) as per-material data."""
    out = torch.zeros((mt.num, MAT_COLS), dtype=torch.float32,
                      device=mt.kind.device)
    out[:, 0] = mt.kind.to(torch.float32)
    out[:, 1:4] = mt.base_color
    out[:, 4:7] = mt.emission
    out[:, 7] = mt.metallic
    out[:, 8] = mt.ior
    out[:, 9:12] = mt.kr
    out[:, 12] = mt.roughness
    if bundle_mip is not None:
        b = mt.bundle.long()
        out[:, 13] = b.to(torch.float32)
        flags = sum((getattr(mt, key) >= 0).to(torch.int64) * bit
                    for key, bit in (("base_tex", TEX_BASE),
                                     ("normal_tex", TEX_NORMAL),
                                     ("mr_tex", TEX_MR),
                                     ("emissive_tex", TEX_EMISSIVE)))
        if bundle_mip.shape[0]:
            bc = torch.clamp_min(b, 0)
            chain = (bundle_mip[:, :, 2] > 0).sum(dim=1)[bc]
            dim0 = torch.maximum(bundle_mip[:, 0, 2], bundle_mip[:, 0, 3])[bc]
            has = b >= 0
            flags = flags + torch.where(has, chain, 0) * (1 << TEX_CHAIN_SHIFT)
            out[:, 15] = torch.where(has, dim0, 0).to(torch.float32)
        out[:, 14] = torch.where(b >= 0, flags, 0).to(torch.float32)
    return out


def pack_tex_attrs(geom) -> torch.Tensor:
    """The texture variant's per-triangle plane [M, 20] f32, read for the
    winner only: corner normals n0-n2 (0:9), corner uvs (9:15), tangent
    (15:18), uv density (18), pad (the shade plane's columns 12-30,
    pallas_pt.py:371-391 without its delta form)."""
    m = geom.num_triangles
    return torch.cat([geom.corner_normal.reshape(m, 9),
                      geom.corner_uv.reshape(m, 6), geom.tangent,
                      geom.uv_density[:, None],
                      torch.zeros((m, 1), dtype=torch.float32,
                                  device=geom.tangent.device)],
                     dim=1).contiguous()


def pack_prims(prims) -> torch.Tensor:
    """CustomPrims → [max(P, 1), 16] f32 rows: params[0:12], mat_id (col
    12), kind (col 13). The reference packs the first 13 columns alike
    (pallas_pt.py:223-234); the kind column replaces its static
    `prim_kinds`, and the kernel switches on it per prim (warp-uniform)."""
    out = torch.zeros((max(prims.num, 1), 16), dtype=torch.float32,
                      device=prims.params.device)
    if prims.num:
        out[:prims.num, 0:12] = prims.params[:, 0:12]
        out[:prims.num, 12] = prims.mat_id.to(torch.float32)
        out[:prims.num, 13] = prims.kind.to(torch.float32)
    return out


def pack_instances(instances) -> torch.Tensor:
    """InstanceTable → [max(I, 1), 16] f32 rows: the world → object 3x4
    inverse, row-major, in cols 0:12 and sbt_offset in col 12
    (pallas_pt.py:244-254)."""
    out = torch.zeros((max(instances.num, 1), 16), dtype=torch.float32,
                      device=instances.inv_transform.device)
    if instances.num:
        out[:instances.num, 0:12] = instances.inv_transform.reshape(-1, 12)
        out[:instances.num, 12] = instances.sbt_offset.to(torch.float32)
    return out


def fused_inst_ranges(scene: DeviceScene) -> tuple:
    """The static (lo, hi) triangle range of each instance; () without
    instances (pallas_pt.py:257-263)."""
    return instance_ranges(scene.instances, scene.num_triangles)


def fused_geometry(scene: DeviceScene) -> str:
    """The kernel's geometry mode: INST with instances (which then ignores
    smooth normals, as pallas_pt.py:1432 does; render_sum_fused refuses a
    textured instanced scene), else TEX for a scene given textures, SMOOTH
    for a smooth mesh, else FLAT."""
    if scene.has_instances:
        return INST
    if scene.has_textures:
        return TEX
    return SMOOTH if scene.geom.smooth else FLAT


def fused_variant(scene: DeviceScene) -> tuple:
    """The kernel instantiation a scene takes: (specular, pbr, prims,
    geometry) (pallas_pt.py:1423-1432), the arguments of
    kernels.pt_fused_name. The geometry mode carries the texture flag
    (TEX). `specular` is the scene's `specular_lanes`: on a textured scene
    a PBR material's metallic-roughness map can make mirror lanes, which
    the engine takes (engine.py:378-384, 479-481) and the TPU kernel,
    without has_specular, drops (pallas_pt.py:1097-1107)."""
    return (scene.specular_lanes, scene.has_pbr, scene.prims.num > 0,
            fused_geometry(scene))


def fused_group_size(scene: DeviceScene) -> int:
    """Triangles a culling group of the kernel on `scene` (the default of
    render_sum_fused's `group`): the whole table (one group, no box test)
    below FUSED_CULL_MIN_TRIS triangles or with instances (their ranges are
    tested whole), else FUSED_GROUP."""
    m = scene.num_triangles
    if scene.has_instances or m < FUSED_CULL_MIN_TRIS:
        return max(m, 1)
    return FUSED_GROUP


def fused_group_closest_plain(tri, boxes, group, o, d, tmin, tmax,
                              with_groups=False):
    """The kernel's culled closest loop in torch (tri the scene's [M, 16]
    tri_consts, boxes fused_group_boxes(geom, group)) → (t [N], id [N]
    int64, -1 for none, tests [N] int64), with_groups also the slab tests
    [N] int64 and the admitted groups [N, groups] bool. Ids equal brute
    force's
    (pallas_bf.closest_hit_plain) bit for bit, ties included."""
    out = _group_walk(tri, boxes, group, o, d, tmin, tmax, False)
    return out if with_groups else out[:3]


def fused_group_any_plain(tri, boxes, group, o, d, tmin, tmax,
                          with_groups=False):
    """The kernel's culled shadow loop in torch → (occluded [N] bool,
    tests [N] int64: up to the first occluder), with_groups also the slab
    tests [N] int64 and the admitted groups [N, groups] bool."""
    out = _group_walk(tri, boxes, group, o, d, tmin, tmax, True)[1:]
    return out if with_groups else out[:2]


def pack_light(light) -> torch.Tensor:
    """ParallelogramLight → [1, 16] f32: corner3 v1_3 v2_3 normal3 emission3 area."""
    return torch.cat([light.corner, light.v1, light.v2, light.normal,
                      light.emission, light.area.reshape(1)]
                     ).reshape(1, 16).to(torch.float32)


def pack_camera(cam_params, plan: "FusedPlan") -> torch.Tensor:
    """Camera dict → [2, 16] f32: eye U V W aperture focal ortho | ortho_half
    miss_color spread (the TPU layout; row 1 col 5 the ray cone's pixel
    spread, engine.pixel_spread, on a textured scene, else 0). One cat on
    the device of the camera's tensors, the ortho flag cast to f32, and the
    plan's miss colour and zero columns: no host-to-device copy. The
    `engine.pack_camera` span."""
    with telemetry.span("engine.pack_camera"):
        parts = [cam_params["eye"], cam_params["U"], cam_params["V"],
                 cam_params["W"], cam_params["aperture"].reshape(1),
                 cam_params["focal_distance"].reshape(1),
                 cam_params["ortho"].to(torch.float32).reshape(1), plan.zero,
                 cam_params["ortho_half"], plan.miss_color]
        if plan.textured:
            parts.append(pixel_spread(cam_params, plan.full_height)
                         .reshape(1))
        parts.append(plan.pad)
        return torch.cat(parts).view(2, 16).to(torch.float32)


def scene_tables(scene: DeviceScene) -> dict:
    """The fused kernel's per-scene inputs on the scene's CUDA device,
    packed and checked once (DeviceScene.fused_tables caches them): the
    instantiation (fused_variant), the triangles with the material id in
    column 15, the prim, material, light and instance rows, the instance
    ranges [max(I, 1), 2] int32, and the corner plane the variant reads for
    the winner only: the smooth variant's corner normals [M, 9] (n0, n1, n2),
    the texture variant's attribute plane [M, 20] (pack_tex_attrs), the
    triangles for the others; and a cache of group boxes by group size
    (render_sum_fused fills it; a flat table's FUSED_GROUP entry is
    DeviceScene.bf_boxes[0], the boxes kernels 1-2 cull by). Raises for a
    scene past the kernel's caps or with a feature it does not render."""
    dev = scene.device
    m, k, p = scene.num_triangles, scene.materials.num, scene.prims.num
    ranges = fused_inst_ranges(scene)
    ni = len(ranges)
    if (m > MAX_FUSED_TRIS or k > MAX_FUSED_MATS or p > MAX_FUSED_PRIMS
            or ni > MAX_FUSED_INST):
        raise ValueError(f"{m} triangles / {k} materials / {p} prims / {ni} "
                         f"instances exceed the fused kernel's "
                         f"{MAX_FUSED_TRIS} / {MAX_FUSED_MATS} / "
                         f"{MAX_FUSED_PRIMS} / {MAX_FUSED_INST}")
    if not set(scene.features) <= FUSED_FEATURES:
        raise ValueError(f"the fused kernel renders no scene with features "
                         f"{scene.features}")
    specular, pbr, has_prims, geometry = fused_variant(scene)
    textured = geometry == TEX
    tri = scene.geom.tri_consts.clone()
    tri[:, 15] = scene.tri_mat.to(torch.float32)
    out = dict(variant=(specular, pbr, has_prims, geometry), tri=tri,
               prims=pack_prims(scene.prims),
               mats=pack_materials(scene.materials,
                                   scene.bundle_mip if textured else None),
               light=pack_light(scene.area_light),
               inst=pack_instances(scene.instances),
               inst_rng=torch.tensor(ranges or ((0, 0),), dtype=torch.int32,
                                     device=dev),
               corner=tri, boxes={})
    if not scene.has_instances and scene.bf_boxes[0] is not None:
        out["boxes"][FUSED_GROUP] = scene.bf_boxes[0]
    if geometry == SMOOTH:
        out["corner"] = scene.geom.corner_normal.reshape(m, 9).contiguous()
        kernels.require(out["corner"], "corner", torch.float32, (m, 9), dev)
    elif textured:
        out["corner"] = pack_tex_attrs(scene.geom)
        kernels.require(out["corner"], "corner", torch.float32,
                        (m, TEX_ATTR_COLS), dev)
    for name, shape in (("tri", (m, 16)), ("prims", (max(p, 1), 16)),
                        ("mats", (k, 16)), ("light", (1, 16)),
                        ("inst", (max(ni, 1), 16))):
        kernels.require(out[name], name, torch.float32, shape, dev)
    kernels.require(out["inst_rng"], "inst_ranges", torch.int32,
                    (max(ni, 1), 2), dev)
    bundles, bundle_mip = scene.bundles, scene.bundle_mip
    kernels.require(bundles, "bundles", torch.float32,
                    tuple(bundles.shape[:3]) + (16,), dev)
    kernels.require(bundle_mip, "bundle_mip", torch.int32,
                    (bundles.shape[0], bundle_mip.shape[1], 4), dev)
    return out


class FusedPlan(NamedTuple):
    """The host prelude of a fused launch of one scene at one launch shape,
    worked out once (fused_plan): the LAUNCHES key, the camera block's
    constant columns (pack_camera) and the library call's arguments other
    than the camera, the subframe, the outputs and the stream."""
    name: str
    textured: bool            # the spread column is engine.pixel_spread's
    full_height: int
    miss_color: torch.Tensor  # [3] f32
    zero: torch.Tensor        # [1] f32 zero: row 0 col 15
    pad: torch.Tensor         # row 1 after the spread ([10]) or from it ([11])
    head: tuple               # tri, m, prims, p, mats, k, light
    tail: tuple               # width, height, ..., boxes, group


def _refuse_unsupported(scene: DeviceScene):
    """Raise for a scene the fused kernel does not render."""
    scene.require_supported()
    if scene.has_cutouts:
        # the kernel has no cut lane: it would draw the holes solid
        # (engine.py:818 keeps such scenes off it)
        raise NotImplementedError("the fused kernel renders no scene with "
                                  "alpha cutouts: use impl='wavefront'")
    if scene.has_motion or scene.has_volume:
        # no shutter time and no volume lane in the kernel
        # (engine.py:819-820 keeps such scenes off it)
        raise NotImplementedError("the fused kernel renders no scene with "
                                  "moving triangles or a volume: use "
                                  "impl='wavefront'")
    if scene.has_textures and scene.has_instances:
        # the reference's kernel drops the textures there
        # (pallas_pt.py:1430-1431); the wavefront renders such a scene
        raise ValueError("the fused kernel renders no textured scene with "
                         "instances: use impl='wavefront'")
    big = [hi - lo for lo, hi in fused_inst_ranges(scene)
           if hi - lo > MAX_FUSED_TRIS]
    if big:
        # kInst tests each range whole; a mesh past the budget walks its
        # own cluster table in the wavefront (engine._use_fused keeps such
        # scenes off the kernel)
        raise ValueError(f"the fused kernel renders no instance range "
                         f"of {big[0]} triangles (past "
                         f"{MAX_FUSED_TRIS}): use impl='wavefront'")


def fused_plan(scene: DeviceScene, width: int, height: int,
               samples_per_launch: int = 1, max_depth: int = 4, y0=0,
               full_width=None, full_height=None, group=None) -> FusedPlan:
    """The launch plan of `scene` at a launch shape (render_sum_fused's
    arguments): DeviceScene.fused_plans' entry, else built and kept there,
    the oldest dropped past MAX_FUSED_PLANS; PLANS counts both. A scene the
    kernel does not render raises and keeps no plan, so it raises on every
    call. Needs no card."""
    full_w = width if full_width is None else full_width
    full_h = height if full_height is None else full_height
    key = (width, height, full_w, full_h, y0, samples_per_launch, max_depth,
           group)
    plans = scene.fused_plans
    plan = plans.get(key)
    if plan is not None:
        PLANS["reused"] += 1
        return plan
    _refuse_unsupported(scene)
    plan = _build_plan(scene, *key)
    if len(plans) >= MAX_FUSED_PLANS:
        del plans[next(iter(plans))]
    plans[key] = plan
    PLANS["built"] += 1
    return plan


def _build_plan(scene: DeviceScene, width, height, full_w, full_h, y0,
                samples_per_launch, max_depth, group) -> FusedPlan:
    if width * height >= 2 ** 31 or full_w * full_h >= 2 ** 32:
        raise ValueError("frame too large for the kernel's 32-bit indices")
    dev = scene.device
    tables = scene.fused_tables
    specular, pbr, has_prims, geometry = tables["variant"]
    group = (fused_group_size(scene)
             if group is None or scene.has_instances
             else min(int(group), max(scene.num_triangles, 1)))
    if group < 1:
        raise ValueError(f"render_sum_fused: group size {group} < 1")
    boxes = tables["boxes"].get(group)
    if boxes is None:
        with telemetry.span("scene.fused_tables"):
            boxes = (fused_group_boxes(scene.geom, group)
                     if group < scene.num_triangles
                     else torch.zeros((1, BOX_COLS), dtype=torch.float32,
                                      device=dev))
        tables["boxes"][group] = boxes
    textured = geometry == TEX
    bundles, bundle_mip = scene.bundles, scene.bundle_mip
    return FusedPlan(
        name=kernels.pt_fused_name(specular, pbr, has_prims, geometry),
        textured=textured, full_height=full_h,
        miss_color=torch.as_tensor(scene.miss_color, dtype=torch.float32,
                                   device=dev),
        zero=torch.zeros((1,), dtype=torch.float32, device=dev),
        pad=torch.zeros((10 if textured else 11,), dtype=torch.float32,
                        device=dev),
        head=(tables["tri"].data_ptr(), scene.num_triangles,
              tables["prims"].data_ptr(), scene.prims.num,
              tables["mats"].data_ptr(), scene.materials.num,
              tables["light"].data_ptr()),
        tail=(width, height, full_w, full_h, y0, samples_per_launch,
              max_depth, int(specular), int(pbr), kernels.GEOMETRY[geometry],
              tables["inst"].data_ptr(), tables["inst_rng"].data_ptr(),
              len(fused_inst_ranges(scene)), tables["corner"].data_ptr(),
              bundles.data_ptr(), bundle_mip.data_ptr(), bundle_mip.shape[1],
              bundles.shape[1], bundles.shape[2], boxes.data_ptr(), group))


def render_sum_fused(scene: DeviceScene, cam_params, width: int, height: int,
                     subframe, samples_per_launch: int = 1,
                     max_depth: int = 4, y0=0, full_width=None,
                     full_height=None, regen=None, group=None):
    """`samples_per_launch` samples of a [height, width] row tile from
    subframe `subframe` → (radiance SUM [H, W, 3], rays_traced int64).

    group: triangles a culling group of the kernel (None:
    fused_group_size(scene); the number of triangles or more: no culling;
    ignored with instances). Every group size gives the same values.

    regen: the TPU kernel's choice between the lock-step and the
    path-regeneration schedules (pallas_pt.py:1318-1372), which give the
    same values. The CUDA kernel runs the regenerating one only: each lane
    traces one segment a step and starts its next sample where a path
    ends, each lane's samples in order, so its values are those of both
    and the argument selects nothing here.

    On the card a launch takes its plan (fused_plan), packs the camera
    (pack_camera) and makes the library call: no host-to-device copy and
    no sync where `subframe` is the device's int64 scalar (Film.subframe).
    The call is the `engine.render_sum_fused` span."""
    with telemetry.span("engine.render_sum_fused"):
        del regen
        dev = scene.device
        if dev.type != "cuda":
            _refuse_unsupported(scene)
            if dev.type != "cpu":
                raise ValueError(f"render_sum_fused: unsupported device {dev}")
            return render_sum_plain(scene, cam_params, width, height, subframe,
                                    samples_per_launch, max_depth=max_depth,
                                    y0=y0, full_width=full_width,
                                    full_height=full_height)
        plan = fused_plan(scene, width, height, samples_per_launch, max_depth,
                          y0, full_width, full_height, group)
        cam = pack_camera(cam_params, plan)
        sub = subframe
        if not (isinstance(sub, torch.Tensor) and sub.dtype == torch.int64
                and sub.dim() == 0 and sub.device == dev):
            sub = torch.as_tensor(subframe, device=dev).to(
                torch.int64).reshape(())
        rad = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
        count = torch.empty((width * height,), dtype=torch.int32, device=dev)
        if width * height == 0:
            return rad, torch.zeros((), dtype=torch.int64, device=dev)
        with torch.cuda.device(dev), kernels.launch(plan.name):
            err = kernels.lib().ort_pt_fused(
                *plan.head, cam.data_ptr(), sub.data_ptr(), *plan.tail,
                rad.data_ptr(), count.data_ptr(), kernels.stream_ptr(dev))
        kernels.check(err, plan.name)
        return rad, count.sum(dtype=torch.int64)
