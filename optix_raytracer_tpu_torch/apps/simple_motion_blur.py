"""Motion blur (counterpart of `apps/simple_motion_blur.py`): a triangle and
a sphere that move between two keys, each ray at its own shutter time,
accumulated progressively.

    python -m optix_raytracer_tpu_torch.apps.simple_motion_blur \\
        --file motionblur.ppm --dim 512x512 --samples 32 [--engine]

The standalone renderer intersects the moving triangle and sphere by torch
ops at a random time a pixel and sample. `--engine` traces a 2-key moving
triangle through the main path tracer beside a static floor and an area
light, one shutter time a path (`wavefront/engine.py`); on a CUDA device
its static floor's closest and NEE queries run kernels 1-2. PNG output
needs Pillow; .ppm needs nothing beyond numpy.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..accel import motion
from ..core import film as film_mod
from ..core import rng as _rng
from ..core.camera import Camera, generate_rays
from ..io.image import save_image
from ..scene.device_scene import DeviceScene, make_device_scene
from ..shade import materials as mat
from ..shade.lights import ParallelogramLight
from ..wavefront.engine import render_accumulate
from ._cli import parse_dim

_TRI0 = np.array([[-1.2, -0.4, 0], [-0.4, -0.4, 0], [-0.8, 0.5, 0]],
                 np.float32)


def make_scene(device):
    """The triangle sweeping right and the sphere sweeping up →
    (MotionTriangles, (centers0, centers1, radii))."""
    tris = motion.MotionTriangles.make(
        _TRI0, _TRI0 + np.array([0.7, 0.0, 0.0], np.float32),
        np.array([[0, 1, 2]], np.int32), device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return tris, (t([[0.7, -0.3, 0.2]]), t([[0.7, 0.45, 0.2]]), t([0.35]))


def render_sample(tris, spheres, cam, width, height, subframe):
    """One sample: a shutter time a pixel (the draw after the camera's),
    flat shading (the triangle orange, the sphere by its normal) →
    radiance [H, W, 3]."""
    dev = cam["eye"].device
    n = width * height
    if isinstance(subframe, torch.Tensor):
        subframe = subframe.to(dev)
    rng = _rng.seed(torch.arange(n, dtype=torch.int64, device=dev), subframe)
    rays, rng = generate_rays(cam, width, height,
                              rng_state=rng.reshape(height, width))
    rays = rays.reshape(n)
    times, _ = _rng.uniform(rng.reshape(n))
    h_tri = motion.intersect_motion_triangles(tris, rays, times)
    h_sph = motion.intersect_motion_spheres(*spheres, rays, times)
    tri_closer = h_tri.valid & (~h_sph.valid | (h_tri.t < h_sph.t))
    sph_hit = h_sph.valid & ~tri_closer

    def c(*v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    sph_col = torch.abs(h_sph.normal) * c(0.2, 0.7, 0.9)
    radiance = torch.where(tri_closer[:, None], c(0.9, 0.45, 0.1),
                           torch.where(sph_hit[:, None], sph_col,
                                       c(0.07, 0.07, 0.10)))
    return radiance.reshape(height, width, 3)


def render(width=512, height=512, samples=16, device="cuda"):
    """The standalone renderer → (linear radiance [H, W, 3], Film)."""
    tris, spheres = make_scene(device)
    cam = Camera(eye=(0, 0, 3.2), lookat=(0, 0, 0), fov_y=45,
                 aspect=width / height).params(device)
    film = film_mod.Film.create(height, width, device)
    for _ in range(samples):
        film = film.accumulate(render_sample(tris, spheres, cam, width,
                                             height, film.subframe))
    return film.accum, film


def engine_scene(device) -> DeviceScene:
    """The floor, the area light and the triangle sweeping 1.4 to the right
    as a 2-key moving triangle of material 1."""
    floor = np.array([[-3, -0.6, -3], [3, -0.6, -3], [3, -0.6, 3],
                      [-3, -0.6, 3]], np.float32)
    return make_device_scene(
        floor, np.array([[0, 2, 1], [0, 3, 2]], np.int32),
        np.zeros(2, np.int32),
        [{"kind": mat.DIFFUSE, "base_color": (0.6, 0.6, 0.65)},
         {"kind": mat.DIFFUSE, "base_color": (0.9, 0.4, 0.2)}], device,
        area_light=ParallelogramLight.make((-1, 3.0, -1), (2, 0, 0),
                                           (0, 0, 2), (10.0, 10.0, 10.0),
                                           device),
        motion={"verts0": _TRI0,
                "verts1": _TRI0 + np.array([1.4, 0.0, 0.0], np.float32),
                "indices": np.array([[0, 1, 2]], np.int32), "tri_mat": 1})


def engine_camera(width, height) -> Camera:
    return Camera(eye=(0, 0.6, 3.2), lookat=(0, -0.1, 0), fov_y=45,
                  aspect=width / height)


def render_engine(width, height, samples, max_depth=2, device="cuda"):
    """Motion blur through the main path tracer: `samples` samples in one
    launch of depth 2 → (linear radiance [H, W, 3], Film, rays_traced)."""
    scene = engine_scene(device)
    cam = engine_camera(width, height).params(device)
    film = film_mod.Film.create(height, width, device)
    film, rays = render_accumulate(scene, cam, film, width, height,
                                   samples_per_launch=samples,
                                   max_depth=max_depth, chunk_size=None)
    return film.accum, film, rays


def main(argv=None):
    p = argparse.ArgumentParser(description="motion blur")
    p.add_argument("--file", default="motionblur.png")
    p.add_argument("--dim", default="512x512")
    p.add_argument("--samples", type=int, default=32)
    p.add_argument("--engine", action="store_true",
                   help="trace the moving triangle through the main path "
                        "tracer (per-path shutter times)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    w, h = parse_dim(args.dim)
    device = torch.device(args.device)
    t0 = time.perf_counter()
    if args.engine:
        accum, film, _ = render_engine(w, h, args.samples, device=device)
    else:
        accum, film = render(w, h, samples=args.samples, device=device)
    img = film_mod.make_color(accum).cpu().numpy()   # synchronises
    dt = time.perf_counter() - t0
    save_image(args.file, img)
    print(f"wrote {args.file} ({'engine, ' if args.engine else ''}"
          f"{int(film.subframe)} time samples, {dt:.2f}s, on {device})")


if __name__ == "__main__":
    main()
