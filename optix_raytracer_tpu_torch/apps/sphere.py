"""One built-in sphere, normal-shaded (counterpart of `apps/sphere.py`,
the `optixSphere` sample): the sphere GAS through the built-in IS module
(`api.builtin_is_module("sphere")`, `optixBuiltinISModuleGet`), and the
closest-hit program's colour n * 0.5 + 0.5.

    python -m optix_raytracer_tpu_torch.apps.sphere --file sphere.ppm

The sphere's intersection is a custom-prim query in torch ops (the
reference's XLA arithmetic; no kernel). PNG output needs Pillow; .ppm
needs nothing beyond numpy.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..api.module import builtin_is_module
from ..core import film
from ..core.camera import Camera, generate_rays
from ..io.image import save_image
from ._cli import parse_dim


def radiance(width=768, height=768, device="cuda"):
    """The sample's image as linear radiance [H, W, 3] on `device`."""
    is_mod = builtin_is_module("sphere", device=device)
    prims = is_mod.make_primitives([(0.0, 0.0, 0.0)], [1.5])
    intersect = is_mod.get("__intersection__sphere")
    cam = Camera(eye=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 0.0), fov_y=60.0,
                 aspect=width / height).params(device)
    rays, _ = generate_rays(cam, width, height, jitter=False)
    hits = intersect(prims, rays.reshape(width * height))
    shade = hits.normal * 0.5 + 0.5          # the closest-hit program
    out = torch.where(hits.valid[:, None], shade, 0.0)
    return out.reshape(height, width, 3)


def render(width=768, height=768, device="cuda"):
    """→ uint8 RGBA [H, W, 4] on `device`."""
    return film.make_color(radiance(width, height, device))


def main(argv=None):
    p = argparse.ArgumentParser(description="one-sphere render (optixSphere)")
    p.add_argument("--file", default="sphere.png")
    p.add_argument("--dim", default="768x768")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    w, h = parse_dim(args.dim)
    t0 = time.perf_counter()
    img = render(w, h, torch.device(args.device)).cpu().numpy()
    dt = time.perf_counter() - t0
    save_image(args.file, img)
    print(f"wrote {args.file} ({w}x{h}, {dt:.3f}s, on {args.device})")


if __name__ == "__main__":
    main()
