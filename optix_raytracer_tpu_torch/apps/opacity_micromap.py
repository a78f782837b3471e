"""Opacity micromaps on an alpha-tested quad (counterpart of
`apps/opacity_micromap.py`): a checker-masked quad over a diffuse floor,
its micromap built at scene setup (accel/micromap.py), rendered with the
classification's statistics (the share of micro-triangles that need no
mask evaluation).

    python -m optix_raytracer_tpu_torch.apps.opacity_micromap \\
        --file omm.ppm --dim 512x512 --samples 16 --level 3

The scene has 4 triangles: on a CUDA device its queries run kernels 1-2.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..accel.micromap import (OPAQUE, TRANSPARENT, UNKNOWN_OPAQUE,
                              build_opacity_micromap, checker_mask)
from ..core import film as film_mod
from ..core.camera import Camera
from ..io.image import save_image
from ..scene.device_scene import make_device_scene
from ..shade import materials as mat
from ..shade.lights import ParallelogramLight
from ..wavefront.engine import render_accumulate
from ._cli import parse_dim

# A power-of-two checker frequency puts the mask's cell edges on the
# micro-triangle lattice from level 2 on, so the conservative classifier
# certifies every micro-triangle.
CHECKER_SCALE = 4.0


def make_scene(device):
    """A masked quad at y = 1 above a diffuse floor, area-lit."""
    verts = np.array([
        [-1, 1.0, -1], [1, 1.0, -1], [1, 1.0, 1], [-1, 1.0, 1],
        [-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3]], np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]], np.int32)
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1],
                    [0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    materials = [
        {"kind": mat.DIFFUSE, "base_color": (0.9, 0.4, 0.2),
         "alpha_mode": mat.ALPHA_MASK, "cutout": mat.CUT_CHECKER,
         "checker_scale": CHECKER_SCALE},
        {"kind": mat.DIFFUSE, "base_color": (0.7, 0.7, 0.75)},
    ]
    light = ParallelogramLight.make((1.5, 4.0, -1.0), (-3.0, 0, 0),
                                    (0, 0, 2.0), (6.0, 6.0, 6.0), device)
    return make_device_scene(verts, idx, np.array([0, 0, 1, 1], np.int32),
                             materials, device, area_light=light, uvs=uvs,
                             miss_color=(0.1, 0.12, 0.2))


def build_micromap(scene, level=3):
    """The checker micromap of every triangle of `scene` at `level` →
    (micro_states [M, 4^level], tri_summary [M]) uint8."""
    return build_opacity_micromap(scene.geom.corner_uv.cpu().numpy(),
                                  checker_mask(CHECKER_SCALE), level=level)


def camera(width, height) -> Camera:
    return Camera(eye=(0, 2.2, 4.0), lookat=(0, 0.7, 0), fov_y=40,
                  aspect=width / height)


def render(width=512, height=512, samples=8, level=3, device="cuda"):
    """`samples` samples in one launch, depth 3 → (linear radiance
    [H, W, 3], stats: the micromap at `level` and its classified
    fractions, rays_traced)."""
    scene = make_scene(device)
    states, summary = build_micromap(scene, level)
    film = film_mod.Film.create(height, width, scene.device)
    film, rays = render_accumulate(scene, camera(width, height).params(
        scene.device), film, width, height, samples_per_launch=samples,
        max_depth=3)
    return film.accum, dict(
        micro_states=states, tri_summary=summary,
        fully_classified_fraction=float((summary != UNKNOWN_OPAQUE).mean()),
        opaque_fraction=float((states == OPAQUE).mean()),
        transparent_fraction=float((states == TRANSPARENT).mean())), rays


def main(argv=None):
    p = argparse.ArgumentParser(description="opacity micromaps")
    p.add_argument("--file", default="omm.png")
    p.add_argument("--dim", default="512x512")
    p.add_argument("--level", type=int, default=3)
    p.add_argument("--samples", type=int, default=16)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    w, h = parse_dim(args.dim)
    device = torch.device(args.device)
    t0 = time.perf_counter()
    accum, stats, rays = render(w, h, samples=args.samples, level=args.level,
                                device=device)
    img = film_mod.make_color(accum).cpu().numpy()   # synchronises
    dt = time.perf_counter() - t0
    save_image(args.file, img)
    print(f"wrote {args.file}; micromap level {args.level}: "
          f"{stats['opaque_fraction']:.0%} opaque, "
          f"{stats['transparent_fraction']:.0%} transparent micro-tris, "
          f"{stats['fully_classified_fraction']:.0%} tris fully classified "
          f"({dt:.2f}s, {int(rays) / dt / 1e6:.2f} Mrays/s, on {device})")


if __name__ == "__main__":
    main()
