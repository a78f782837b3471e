"""SRT motion transforms (counterpart of `apps/motion_geometry.py`): a fan
blade of two triangles spun and lifted between two SRT keys. Each ray's
shutter time interpolates the keys, the ray drops into object space, the
static blades answer it, and the hit's normal goes back to world space.

    python -m optix_raytracer_tpu_torch.apps.motion_geometry \\
        --file motiongeom.ppm --dim 512x512 --samples 32

On a CUDA device the object-space rays run kernel 1
(`bruteforce.intersect_closest`). PNG output needs Pillow; .ppm needs
nothing beyond numpy.
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from ..accel import bruteforce as bf
from ..accel import motion
from ..accel.geometry import build_triangle_geometry
from ..core import film as film_mod
from ..core import rng as _rng
from ..core.camera import Camera, generate_rays
from ..io.image import save_image
from ._cli import parse_dim


def make_geom(device):
    """The unit fan blade: two thin triangles through the origin."""
    verts = np.array([[0, 0, 0], [1.0, 0.08, 0], [1.0, -0.08, 0],
                      [0, 0, 0], [-1.0, 0.08, 0], [-1.0, -0.08, 0]],
                     np.float32)
    return build_triangle_geometry(verts, np.array([[0, 1, 2], [3, 4, 5]],
                                                   np.int32), device)


def make_keys(device, spin_radians=0.6):
    """The two SRT keys: a spin of spin_radians about z, and a lift of 0.15
    at the second."""
    half = spin_radians / 2
    return (motion.SRTKey.make(device, quat=(0, 0, math.sin(-half),
                                             math.cos(-half))),
            motion.SRTKey.make(device, quat=(0, 0, math.sin(half),
                                             math.cos(half)),
                               trans=(0.0, 0.15, 0.0)))


def render_sample(geom, key0, key1, cam, width, height, subframe):
    """One sample: a shutter time a pixel (the draw after the camera's), the
    blades hit in object space, shaded by the world normal → radiance
    [H, W, 3]."""
    dev = cam["eye"].device
    n = width * height
    if isinstance(subframe, torch.Tensor):
        subframe = subframe.to(dev)
    rng = _rng.seed(torch.arange(n, dtype=torch.int64, device=dev), subframe)
    rays, rng = generate_rays(cam, width, height,
                              rng_state=rng.reshape(height, width))
    rays = rays.reshape(n)
    times, _ = _rng.uniform(rng.reshape(n))
    srt = motion.srt_interpolate(key0, key1, times)
    hits = bf.intersect_closest(geom, motion.rays_to_object_space(rays, srt),
                                chunk_size=None)
    hits = motion.hits_to_world_space(hits, srt)

    def c(*v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    radiance = torch.where(hits.valid[:, None],
                           torch.abs(hits.normal) * c(0.9, 0.8, 0.3),
                           c(0.05, 0.06, 0.1))
    return radiance.reshape(height, width, 3)


def camera(width, height) -> Camera:
    return Camera(eye=(0, 0, 3.0), lookat=(0, 0, 0), fov_y=50,
                  aspect=width / height)


def render(width=512, height=512, samples=16, spin_radians=0.6,
           device="cuda"):
    """→ (linear radiance [H, W, 3], Film)."""
    geom = make_geom(device)
    key0, key1 = make_keys(device, spin_radians)
    cam = camera(width, height).params(device)
    film = film_mod.Film.create(height, width, device)
    for _ in range(samples):
        film = film.accumulate(render_sample(geom, key0, key1, cam, width,
                                             height, film.subframe))
    return film.accum, film


def main(argv=None):
    p = argparse.ArgumentParser(description="SRT motion transforms")
    p.add_argument("--file", default="motiongeom.png")
    p.add_argument("--dim", default="512x512")
    p.add_argument("--samples", type=int, default=32)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    w, h = parse_dim(args.dim)
    device = torch.device(args.device)
    t0 = time.perf_counter()
    accum, film = render(w, h, samples=args.samples, device=device)
    img = film_mod.make_color(accum).cpu().numpy()   # synchronises
    dt = time.perf_counter() - t0
    save_image(args.file, img)
    print(f"wrote {args.file} ({int(film.subframe)} time samples, "
          f"{dt:.2f}s, on {device})")


if __name__ == "__main__":
    main()
