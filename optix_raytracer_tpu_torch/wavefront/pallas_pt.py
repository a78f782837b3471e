"""The fused path-trace kernel (kernel 3 and its variants 3') and its plain
version (counterpart of `wavefront/pallas_pt.py:206-286, 371-391, 398-1378,
1392-1495`; the kernel is `csrc/pt_fused.cuh`, instantiated by
`csrc/pt_fused.cu`, `pt_fused_inst.cu` and `pt_fused_smooth.cu`).

`render_sum_fused` renders `samples_per_launch` progressive samples of a row
tile in one launch and returns their radiance SUM and the rays traced. On
CUDA tensors it launches the kernel; on CPU tensors it runs the plain
version, the wavefront engine's `render_sample` loop over the same
subframes, which is the relation the JAX package keeps between
`engine.render_sample` and its megakernel.

The kernel is a template over a geometry mode and the TPU kernel's static
flags <specular, pbr, prims>: `has_specular` (glass or mirror materials),
`has_pbr` (rough metallic-roughness lanes) and the inline custom prims (at
most MAX_FUSED_PRIMS of FUSED_PRIM_KINDS). The geometry mode is "flat", "inst"
(`inst_ranges`: at most MAX_FUSED_INST instances over the shared triangles,
each ray moved into each instance's object space) or "smooth" (the winner's
corner normals interpolated, as the engine's shading-frame epilogue does);
instances and smooth normals never meet (pallas_pt.py:1432), so 3 x 8
instantiations exist. <flat, false, false, false> is the Cornell
configuration. Each instantiation counts its launches under its own
`kernels.LAUNCHES` key (`kernels.pt_fused_name`). The texture variant is not
ported yet (ROADMAP.md Queue 2 item 3).
"""
from __future__ import annotations

import torch

from .. import kernels
from ..accel.tlas import instance_ranges
from ..scene.device_scene import DeviceScene
# The plain version of kernel 3 is the wavefront engine's sample loop (on
# CUDA tensors its intersections come from kernels 1 and 2).
from .engine import render_sum_wavefront as render_sum_plain

MAT_COLS = 16   # kind, base3, emission3, metallic, ior, kr3, roughness, pad3
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
FLAT, INST, SMOOTH = "flat", "inst", "smooth"


def pack_materials(mt) -> torch.Tensor:
    """MaterialTable → [K, 16] f32 rows."""
    out = torch.zeros((mt.num, MAT_COLS), dtype=torch.float32,
                      device=mt.kind.device)
    out[:, 0] = mt.kind.to(torch.float32)
    out[:, 1:4] = mt.base_color
    out[:, 4:7] = mt.emission
    out[:, 7] = mt.metallic
    out[:, 8] = mt.ior
    out[:, 9:12] = mt.kr
    out[:, 12] = mt.roughness
    return out


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
    smooth normals, as pallas_pt.py:1432 does), else SMOOTH for a smooth
    mesh, else FLAT."""
    if scene.has_instances:
        return INST
    return SMOOTH if scene.geom.smooth else FLAT


def fused_variant(scene: DeviceScene) -> tuple:
    """The kernel instantiation a scene takes: (specular, pbr, prims,
    geometry) (pallas_pt.py:1423-1432), the arguments of
    kernels.pt_fused_name."""
    return (scene.has_specular, scene.has_pbr, scene.prims.num > 0,
            fused_geometry(scene))


def pack_light(light) -> torch.Tensor:
    """ParallelogramLight → [1, 16] f32: corner3 v1_3 v2_3 normal3 emission3 area."""
    return torch.cat([light.corner, light.v1, light.v2, light.normal,
                      light.emission, light.area.reshape(1)]
                     ).reshape(1, 16).to(torch.float32)


def pack_camera(cam_params, miss_color) -> torch.Tensor:
    """Camera dict → [2, 16] f32: eye U V W aperture focal ortho | ortho_half
    miss_color (the TPU layout; row 1 col 5, the texture cone spread, is 0)."""
    dev = cam_params["eye"].device
    row0 = torch.cat([
        cam_params["eye"], cam_params["U"], cam_params["V"], cam_params["W"],
        cam_params["aperture"].reshape(1),
        cam_params["focal_distance"].reshape(1),
        cam_params["ortho"].to(torch.float32).reshape(1),
        torch.zeros((1,), dtype=torch.float32, device=dev)])
    row1 = torch.cat([cam_params["ortho_half"],
                      torch.as_tensor(miss_color, dtype=torch.float32,
                                      device=dev),
                      torch.zeros((11,), dtype=torch.float32, device=dev)])
    return torch.stack([row0, row1]).to(torch.float32)


def render_sum_fused(scene: DeviceScene, cam_params, width: int, height: int,
                     subframe, samples_per_launch: int = 1,
                     max_depth: int = 4, y0=0, full_width=None,
                     full_height=None, regen=None):
    """`samples_per_launch` samples of a [height, width] row tile from
    subframe `subframe` → (radiance SUM [H, W, 3], rays_traced int64).

    regen: the TPU kernel's choice between the lock-step and the
    path-regeneration schedules (pallas_pt.py:1318-1372), which give the
    same values. The CUDA kernel's per-thread loop ends each path where it
    dies, which is both, so the argument selects nothing here."""
    del regen
    scene.require_supported()
    dev = scene.device
    if dev.type == "cpu":
        return render_sum_plain(scene, cam_params, width, height, subframe,
                                samples_per_launch, max_depth=max_depth,
                                y0=y0, full_width=full_width,
                                full_height=full_height)
    if dev.type != "cuda":
        raise ValueError(f"render_sum_fused: unsupported device {dev}")
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
    full_w = width if full_width is None else full_width
    full_h = height if full_height is None else full_height
    n = width * height
    if n >= 2 ** 31 or full_w * full_h >= 2 ** 32:
        raise ValueError("frame too large for the kernel's 32-bit indices")

    # tri_consts column 15 carries the material id for the fused kernel.
    tri = scene.geom.tri_consts.clone()
    tri[:, 15] = scene.tri_mat.to(torch.float32)
    prims = pack_prims(scene.prims)
    mats = pack_materials(scene.materials)
    light = pack_light(scene.area_light)
    cam = pack_camera(cam_params, scene.miss_color)
    inst = pack_instances(scene.instances)
    specular, pbr, has_prims, geometry = fused_variant(scene)
    # The instance ranges [max(I, 1), 2] int32, and the smooth variant's
    # corner normals [M, 9] f32 (n0, n1, n2), read for the winner only
    # (the other variants read no corner plane and get the triangles).
    inst_rng = torch.tensor(ranges or ((0, 0),), dtype=torch.int32,
                            device=dev)
    corner = tri
    if geometry == SMOOTH:
        corner = scene.geom.corner_normal.reshape(m, 9).contiguous()
        kernels.require(corner, "corner", torch.float32, (m, 9), dev)
    sub = torch.as_tensor(subframe, device=dev).to(torch.int64).reshape(())
    for name, t, shape in (("tri", tri, (m, 16)),
                           ("prims", prims, (max(p, 1), 16)),
                           ("mats", mats, (k, 16)),
                           ("light", light, (1, 16)), ("cam", cam, (2, 16)),
                           ("inst", inst, (max(ni, 1), 16))):
        kernels.require(t, name, torch.float32, shape, dev)
    kernels.require(inst_rng, "inst_ranges", torch.int32, (max(ni, 1), 2),
                    dev)
    kernels.require(sub, "subframe", torch.int64, (), dev)

    rad = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    count = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return rad, torch.zeros((), dtype=torch.int64, device=dev)
    name = kernels.pt_fused_name(specular, pbr, has_prims, geometry)
    with torch.cuda.device(dev):
        err = kernels.lib().ort_pt_fused(
            tri.data_ptr(), m, prims.data_ptr(), p, mats.data_ptr(), k,
            light.data_ptr(), cam.data_ptr(), sub.data_ptr(), width, height,
            full_w, full_h, y0, samples_per_launch, max_depth, int(specular),
            int(pbr), kernels.GEOMETRY[geometry], inst.data_ptr(),
            inst_rng.data_ptr(), ni, corner.data_ptr(), rad.data_ptr(),
            count.data_ptr(), kernels.stream_ptr(dev))
        kernels.LAUNCHES[name] += 1
    kernels.check(err, name)
    return rad, count.sum(dtype=torch.int64)

