"""Ribbon curves (counterpart of `apps/ribbons.py`): fourteen Catmull-Rom
strands, each segment a flat parallelogram spanning its width across the
strand, shaded by the Whitted integrator.

    python -m optix_raytracer_tpu_torch.apps.ribbons --file ribbons.ppm \\
        --dim 512x512

The scene's one triangle is a degenerate placeholder: on a CUDA device its
queries run kernels 1-2, the ribbons are intersected by torch ops. PNG
output needs Pillow; .ppm needs nothing beyond numpy.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..accel import curves as cv
from ..accel import primitives as prim
from ..core import film as film_mod
from ..core.camera import Camera
from ..io.image import save_image
from ..scene.device_scene import DeviceScene, make_device_scene
from ..shade import materials as mat
from ..shade.lights import AMBIENT, DIRECTIONAL
from ..wavefront.whitted import render_whitted_sample
from ._cli import parse_dim
from .curves import EMPTY_INDICES, EMPTY_VERTS


def ribbon_prims(num_ribbons=14, seed=2):
    """The strands' ribbon prim dicts, control points from
    default_rng(seed), materials 0-2 in turn."""
    rng = np.random.default_rng(seed)
    descs = []
    for i in range(num_ribbons):
        x0 = -1.2 + 2.4 * i / max(num_ribbons - 1, 1)
        ctrl = np.stack([
            np.full(6, x0, np.float32) + 0.15 * rng.normal(size=6),
            np.linspace(-0.8, 0.9, 6),
            0.3 * rng.normal(size=6)], 1).astype(np.float32)
        widths = np.full(6, 0.05, np.float32)
        pts, rad, _ = cv.eval_spline(ctrl, widths, cv.CATMULL_ROM, 6)
        descs.extend(cv.strand_to_ribbons(pts, rad, normal=(0, 0, 1),
                                          mat_id=i % 3))
    return descs


def make_ribbon_scene(device, num_ribbons=14, seed=2) -> DeviceScene:
    def phong(c):
        return {"kind": mat.PHONG, "base_color": c,
                "specular": (0.3, 0.3, 0.3), "phong_exp": 20.0}

    return make_device_scene(
        EMPTY_VERTS, EMPTY_INDICES, np.zeros(1, np.int32),
        [phong((0.85, 0.25, 0.2)), phong((0.2, 0.65, 0.3)),
         phong((0.25, 0.35, 0.9))], device,
        prims=prim.make_prims(ribbon_prims(num_ribbons, seed), device),
        lights=[{"kind": DIRECTIONAL, "direction": (-0.3, -0.7, -0.65),
                 "color": (0.95, 0.95, 0.9)},
                {"kind": AMBIENT, "color": (0.28, 0.28, 0.3)}],
        miss_color=(0.1, 0.11, 0.14))


def camera(width, height) -> Camera:
    return Camera(eye=(0, 0.1, 3.2), lookat=(0, 0.05, 0), fov_y=40,
                  aspect=width / height)


def render(width=512, height=512, samples=4, device="cuda", scene=None):
    """`samples` Whitted samples of depth 2 → (linear radiance [H, W, 3],
    Film, rays_traced)."""
    scene = scene if scene is not None else make_ribbon_scene(device)
    cam = camera(width, height).params(scene.device)
    film = film_mod.Film.create(height, width, scene.device)
    rays = torch.zeros((), dtype=torch.int64, device=scene.device)
    for _ in range(samples):
        radiance, r = render_whitted_sample(scene, cam, width, height,
                                            film.subframe, max_depth=2)
        film = film.accumulate(radiance)
        rays = rays + r
    return film.accum, film, rays


def main(argv=None):
    p = argparse.ArgumentParser(description="ribbon curves")
    p.add_argument("--file", default="ribbons.png")
    p.add_argument("--dim", default="512x512")
    p.add_argument("--samples", type=int, default=8)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    w, h = parse_dim(args.dim)
    device = torch.device(args.device)
    t0 = time.perf_counter()
    accum, film, _ = render(w, h, samples=args.samples, device=device)
    img = film_mod.make_color(accum).cpu().numpy()   # synchronises
    dt = time.perf_counter() - t0
    save_image(args.file, img)
    print(f"wrote {args.file} ({dt:.2f}s, on {device})")


if __name__ == "__main__":
    main()
