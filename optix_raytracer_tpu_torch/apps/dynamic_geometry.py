"""Animated vertices with a per-frame GAS refit, or animated instances
(counterpart of `apps/dynamic_geometry.py`, the `optixDynamicGeometry`
sample).

A vertex generator deforms a 24x24 grid (1,152 triangles) into travelling
waves each frame; `api.refit_gas` rebuilds its tables and its LBVH on the
device (`OPTIX_BUILD_OPERATION_UPDATE`, `optixDynamicGeometry.cpp:412-435`)
and the frame is path traced (4 samples, depth 2) through the grid's
cluster table (kernels 4-6 on CUDA). With `--ias` the geometry is built
once, two instances of a 128-triangle grid, and each frame replaces only
the instance matrices (`optixDynamicGeometry.cpp`'s IAS update); the fused
kernel's instance variant (3', kInst) renders it on CUDA.

    python -m optix_raytracer_tpu_torch.apps.dynamic_geometry --file dyn.ppm
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..accel.tlas import make_instances
from ..api.accel import build_gas, refit_gas
from ..core import film as film_mod
from ..core.camera import Camera
from ..io.image import save_image
from ..scene.device_scene import make_device_scene
from ..scene.scene import Scene
from ..shade import materials as mat
from ..shade.lights import ParallelogramLight
from ..wavefront.engine import render_accumulate
from ._cli import parse_dim

LIGHT = ((-0.5, 2.0, -0.5), (1.0, 0, 0), (0, 0, 1.0), (8.0, 8.0, 8.0))


def make_grid_mesh(n: int = 24, size: float = 2.0):
    """A flat (n+1)² vertex grid, deformed per frame into waves (the
    sample's `generate_vertices` kernel role)."""
    xs = np.linspace(-size / 2, size / 2, n + 1, dtype=np.float32)
    zs = np.linspace(-size / 2, size / 2, n + 1, dtype=np.float32)
    gx, gz = np.meshgrid(xs, zs)
    verts = np.stack([gx, np.zeros_like(gx), gz], axis=-1).reshape(-1, 3)
    idx = []
    for j in range(n):
        for i in range(n):
            a = j * (n + 1) + i
            idx += [(a, a + 1, a + n + 1), (a + 1, a + n + 2, a + n + 1)]
    return verts, np.asarray(idx, np.int32)


def animate_vertices(base_verts: torch.Tensor, time_val: float):
    """The per-frame vertex generator: travelling sine waves."""
    x = base_verts[:, 0]
    z = base_verts[:, 2]
    y = 0.25 * torch.sin(4.0 * x + 3.0 * time_val) * torch.cos(
        4.0 * z + 2.0 * time_val)
    return torch.stack([x, y, z], dim=1)


def _camera(width, height, device):
    return Camera(eye=(0, 2.2, 3.2), lookat=(0, 0, 0), fov_y=35,
                  aspect=width / height).params(device)


def render_frame(handle, time_val, base_verts, width, height, samples=4):
    """One frame on the handle's device: refit, scene, path trace → (accum
    [H, W, 3], the refit handle)."""
    dev = handle.indices.device
    verts_t = animate_vertices(
        torch.as_tensor(base_verts, dtype=torch.float32, device=dev),
        time_val)
    handle = refit_gas(handle, verts_t)     # the per-frame GAS update
    scene = make_device_scene(
        verts_t, handle.indices, np.zeros(handle.geom.num_triangles,
                                          np.int32),
        [{"kind": mat.DIFFUSE, "base_color": (0.4, 0.6, 0.9)}], dev,
        area_light=ParallelogramLight.make(*LIGHT, dev))
    film = film_mod.Film.create(height, width, dev)
    film, _ = render_accumulate(scene, _camera(width, height, dev), film,
                                width, height, samples_per_launch=samples,
                                max_depth=2, chunk_size=None)
    return film.accum, handle


def _xform(dx, dy, angle):
    c, sn = np.cos(angle), np.sin(angle)
    t = np.eye(4, dtype=np.float32)
    t[0, 0] = c
    t[0, 2] = sn
    t[2, 0] = -sn
    t[2, 2] = c
    t[:3, 3] = (dx, dy, 0.0)
    return t


def render_frames_ias(width, height, frames, samples=4, device="cuda"):
    """The sample's other mode: the geometry never changes, only the two
    instances' matrices; the DeviceScene is built once and each frame
    replaces its instance table → the last frame's accum [H, W, 3]."""
    s = Scene()
    s.add_material({"kind": mat.DIFFUSE, "base_color": (0.4, 0.6, 0.9)})
    s.add_material({"kind": mat.DIFFUSE, "base_color": (0.9, 0.5, 0.3)})
    verts, idx = make_grid_mesh(n=8, size=1.0)
    mi = s.add_mesh(verts, idx, material=0)
    s.add_instance(mi)
    s.add_instance(mi, sbt_offset=1)
    scene = s.finalize(device,
                       area_light=ParallelogramLight.make(*LIGHT, device))
    cam = _camera(width, height, device)
    accum = None
    for f in range(frames):
        a = 0.5 * f
        table = make_instances([_xform(-0.7, 0.15 * np.sin(a), a),
                                _xform(0.7, 0.15 * np.cos(a), -a)], device,
                               sbt_offsets=np.asarray([0, 1], np.int32),
                               prim_ranges=scene.instances.prim_ranges)
        frame_scene = dataclasses.replace(scene, instances=table)
        film = film_mod.Film.create(height, width, device)
        film, _ = render_accumulate(frame_scene, cam, film, width, height,
                                    samples_per_launch=samples, max_depth=2,
                                    chunk_size=None)
        accum = film.accum
    return accum


def render(width=512, height=512, frames=4, ias=False, device="cuda"):
    """The app's run → the last frame's accum [H, W, 3] on `device`."""
    if ias:
        return render_frames_ias(width, height, frames, device=device)
    base_verts, idx = make_grid_mesh()
    handle = build_gas(base_verts, idx, device=device)
    accum = None
    for f in range(frames):
        accum, handle = render_frame(handle, 0.4 * f, base_verts, width,
                                     height)
    return accum


def main(argv=None):
    p = argparse.ArgumentParser(
        description="animated geometry + GAS refit (optixDynamicGeometry)")
    p.add_argument("--file", default="dynamic.png")
    p.add_argument("--dim", default="512x512")
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--ias", action="store_true",
                   help="animate instance matrices instead of vertices "
                        "(IAS update: geometry built once)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    w, h = parse_dim(args.dim)
    t0 = time.perf_counter()
    accum = render(w, h, args.frames, ias=args.ias,
                   device=torch.device(args.device))
    img = film_mod.make_color(accum).cpu().numpy()    # synchronises
    dt = time.perf_counter() - t0
    save_image(args.file, img)
    print(f"wrote {args.file} ({'IAS mode, ' if args.ias else ''}frame "
          f"{args.frames - 1}, {1e3 * dt / args.frames:.1f} ms a frame, on "
          f"{args.device})")


if __name__ == "__main__":
    main()
