"""The fused path-trace kernel (kernel 3) and its plain version (counterpart
of `wavefront/pallas_pt.py:206-286, 1392-1495`; the kernel is
`csrc/pt_fused.cu`).

`render_sum_fused` renders `samples_per_launch` progressive samples of a row
tile in one launch and returns their radiance SUM and the rays traced. On
CUDA tensors it launches the kernel; on CPU tensors it runs the plain
version, the wavefront engine's `render_sample` loop over the same
subframes, which is the relation the JAX package keeps between
`engine.render_sample` and its megakernel.

The kernel covers the Cornell configuration: diffuse and emissive
materials, no custom prims, no instances, no textures. The specular, PBR,
prim, instance, smooth-normal and texture variants of the TPU kernel are not
ported yet (ROADMAP.md Queue 2 item 2).
"""
from __future__ import annotations

import torch

from .. import kernels
from ..scene.device_scene import DeviceScene
# The plain version of kernel 3 is the wavefront engine's sample loop (on
# CUDA tensors its intersections come from kernels 1 and 2).
from .engine import render_sum_wavefront as render_sum_plain

MAT_COLS = 16   # kind, base3, emission3, metallic, ior, kr3, roughness, pad3
# Triangles + materials are staged in shared memory: (512 + 128) rows of 64
# bytes stay under the 48 KB a block gets without opting in to more.
MAX_FUSED_TRIS = 512
MAX_FUSED_MATS = 128


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
                     full_height=None):
    """`samples_per_launch` samples of a [height, width] row tile from
    subframe `subframe` → (radiance SUM [H, W, 3], rays_traced int64)."""
    scene.require_cornell_subset()
    dev = scene.device
    if dev.type == "cpu":
        return render_sum_plain(scene, cam_params, width, height, subframe,
                                samples_per_launch, max_depth=max_depth,
                                y0=y0, full_width=full_width,
                                full_height=full_height)
    if dev.type != "cuda":
        raise ValueError(f"render_sum_fused: unsupported device {dev}")
    m, k = scene.num_triangles, scene.materials.num
    if m > MAX_FUSED_TRIS or k > MAX_FUSED_MATS:
        raise ValueError(f"{m} triangles / {k} materials exceed the fused "
                         f"kernel's {MAX_FUSED_TRIS} / {MAX_FUSED_MATS}")
    full_w = width if full_width is None else full_width
    full_h = height if full_height is None else full_height
    n = width * height
    if n >= 2 ** 31 or full_w * full_h >= 2 ** 32:
        raise ValueError("frame too large for the kernel's 32-bit indices")

    # tri_consts column 15 carries the material id for the fused kernel.
    tri = scene.geom.tri_consts.clone()
    tri[:, 15] = scene.tri_mat.to(torch.float32)
    mats = pack_materials(scene.materials)
    light = pack_light(scene.area_light)
    cam = pack_camera(cam_params, scene.miss_color)
    sub = torch.as_tensor(subframe, device=dev).to(torch.int64).reshape(())
    for name, t, shape in (("tri", tri, (m, 16)), ("mats", mats, (k, 16)),
                           ("light", light, (1, 16)), ("cam", cam, (2, 16))):
        kernels.require(t, name, torch.float32, shape, dev)
    kernels.require(sub, "subframe", torch.int64, (), dev)

    rad = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    count = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return rad, torch.zeros((), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = kernels.lib().ort_pt_fused_cornell(
            tri.data_ptr(), m, mats.data_ptr(), k, light.data_ptr(),
            cam.data_ptr(), sub.data_ptr(), width, height, full_w, full_h,
            y0, samples_per_launch, max_depth, rad.data_ptr(),
            count.data_ptr(), kernels.stream_ptr(dev))
        kernels.LAUNCHES["pt_fused_cornell"] += 1
    kernels.check(err, "pt_fused_cornell")
    return rad, count.sum(dtype=torch.int64)

