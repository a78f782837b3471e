"""One triangle, a pinhole camera and barycentric shading (counterpart of
`apps/triangle.py`, the `optixTriangle` sample): a GAS of one triangle,
`__raygen__rg` pinhole rays, `__closesthit__ch` writing the barycentrics
as RGB and `__miss__ms` a constant background.

    python -m optix_raytracer_tpu_torch.apps.triangle --file tri.ppm

The closest hits come from kernel 1 (`csrc/bf.cu`) on a CUDA device and from
its plain version on the CPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..accel import bruteforce as bf
from ..accel.geometry import build_triangle_geometry
from ..core import film
from ..core.camera import Camera, generate_rays
from ..io.image import save_image, to_ascii
from ._cli import parse_dim

# The sample's triangle, in world units, and its background.
TRIANGLE_VERTICES = np.array(
    [[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0], [0.0, 0.5, 0.0]], np.float32)
MISS_COLOR = np.array([0.0, 0.1, 0.3], np.float32)


def make_camera(width, height):
    return Camera(eye=(0.0, 0.0, 2.0), lookat=(0.0, 0.0, 0.0),
                  up=(0.0, 1.0, 0.0), fov_y=45.0, aspect=width / height)


def radiance(width=768, height=768, device="cuda"):
    """The frame as linear radiance [H, W, 3] on `device`: barycentrics
    (u, v, 1 - u - v) where a ray hits, MISS_COLOR elsewhere."""
    geom = build_triangle_geometry(TRIANGLE_VERTICES,
                                   np.array([[0, 1, 2]], np.int32), device)
    cam = make_camera(width, height).params(device)
    rays, _ = generate_rays(cam, width, height, jitter=False)
    hits = bf.intersect_closest(geom, rays)
    u, v = hits.uv[..., 0], hits.uv[..., 1]
    ch = torch.stack([u, v, torch.clamp(1.0 - u - v, 0.0, 1.0)], dim=-1)
    miss = torch.as_tensor(MISS_COLOR, device=ch.device).expand(ch.shape)
    return torch.where(hits.valid[..., None], ch, miss)


def render(width=768, height=768, device="cuda"):
    """→ uint8 RGBA [H, W, 4] on `device`."""
    return film.make_color(radiance(width, height, device))


def main(argv=None):
    p = argparse.ArgumentParser(description="one-triangle render "
                                            "(optixTriangle)")
    p.add_argument("--file", default="triangle.png")
    p.add_argument("--dim", default="768x768")
    p.add_argument("--ascii", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    w, h = parse_dim(args.dim)
    t0 = time.perf_counter()
    img = render(w, h, torch.device(args.device)).cpu().numpy()
    dt = time.perf_counter() - t0
    save_image(args.file, img)
    if args.ascii:
        print(to_ascii(img))
    print(f"wrote {args.file} ({w}x{h}, {dt:.3f}s, on {args.device})")


if __name__ == "__main__":
    main()
