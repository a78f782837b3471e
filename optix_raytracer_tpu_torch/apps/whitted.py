"""The Whitted renderer (counterpart of `apps/whitted.py`): a glass sphere
shell and a phong sphere over a checkered floor, a point and an ambient
light, reflection and refraction with shadows, progressive accumulation.

    python -m optix_raytracer_tpu_torch.apps.whitted --file whitted.ppm \\
        --dim 768x576 --samples 16 --depth 6

On a CUDA device the triangle queries run kernels 1-2 (the scene's one
triangle is degenerate; its custom prims are intersected by torch ops).
PNG output needs Pillow; .ppm needs nothing beyond numpy.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..core import film as film_mod
from ..io.image import save_image, to_ascii
from ..scene.builtins import whitted_camera, whitted_scene
from ..wavefront.whitted import render_whitted
from ._cli import parse_dim


def render(width=768, height=576, samples=4, max_depth=6, scene=None,
           camera=None, device="cuda"):
    """Render on `device` → (linear radiance [H, W, 3], Film,
    rays_traced)."""
    scene = scene if scene is not None else whitted_scene(device)
    cam = (camera if camera is not None
           else whitted_camera(width, height)).params(scene.device)
    film, rays = render_whitted(scene, cam, width, height, samples,
                                max_depth=max_depth)
    return film.accum, film, rays


def main(argv=None):
    p = argparse.ArgumentParser(description="Whitted renderer")
    p.add_argument("--file", default="whitted.png")
    p.add_argument("--dim", default="768x576")
    p.add_argument("--samples", type=int, default=16)
    p.add_argument("--depth", type=int, default=6)
    p.add_argument("--ascii", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    w, h = parse_dim(args.dim)
    device = torch.device(args.device)
    t0 = time.perf_counter()
    accum, film, rays = render(w, h, samples=args.samples,
                               max_depth=args.depth, device=device)
    img = film_mod.make_color(accum).cpu().numpy()   # synchronises
    dt = time.perf_counter() - t0
    save_image(args.file, img)
    if args.ascii:
        print(to_ascii(img))
    print(f"wrote {args.file} ({w}x{h}, {int(film.subframe)} spp, "
          f"{dt:.2f}s, {int(rays) / dt / 1e6:.2f} Mrays/s, on {device})")


if __name__ == "__main__":
    main()
