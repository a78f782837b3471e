"""Curve primitives (counterpart of `apps/curves.py`): a spiral strand in
any of the five bases, tessellated into capsules (kind 3), or with
`--swept` as its true swept spans (kinds 4-5), shaded by the Whitted
integrator under a directional and an ambient light.

    python -m optix_raytracer_tpu_torch.apps.curves --file curves.ppm \\
        --dim 512x512 --kind cubic_bspline [--swept]

The scene's one triangle is a degenerate placeholder: on a CUDA device its
queries run kernels 1-2, the prims are intersected by torch ops. PNG output
needs Pillow; .ppm needs nothing beyond numpy.
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

KINDS = [cv.LINEAR, cv.QUADRATIC_BSPLINE, cv.CUBIC_BSPLINE, cv.CATMULL_ROM,
         cv.BEZIER]

# The placeholder mesh of the curve scenes: one degenerate triangle.
EMPTY_VERTS = np.zeros((3, 3), np.float32)
EMPTY_INDICES = np.zeros((1, 3), np.int32)


def curve_prims(kind=cv.CUBIC_BSPLINE, samples_per_segment=10, swept=False):
    """The spiral strand's prim dicts: swept spans for a quadratic or cubic
    basis with `swept`, else capsules through the evaluated spline."""
    ts = np.linspace(0, 2.2 * np.pi, 10)
    control = np.stack([0.7 * np.cos(ts), np.linspace(-0.8, 0.8, len(ts)),
                        0.7 * np.sin(ts)], 1).astype(np.float32)
    widths = np.linspace(0.12, 0.03, len(ts)).astype(np.float32)
    if swept and kind == cv.QUADRATIC_BSPLINE:
        return cv.strand_to_swept_quads(control, widths, mat_id=0)
    if swept and kind in (cv.CUBIC_BSPLINE, cv.CATMULL_ROM, cv.BEZIER):
        return cv.strand_to_swept_cubics(control, widths, kind=kind, mat_id=0)
    pts, radii, _ = cv.eval_spline(control, widths, kind, samples_per_segment)
    return cv.strand_to_capsules(pts, radii, mat_id=0)


def make_curve_scene(device, kind=cv.CUBIC_BSPLINE, samples_per_segment=10,
                     swept=False) -> DeviceScene:
    return make_device_scene(
        EMPTY_VERTS, EMPTY_INDICES, np.zeros(1, np.int32),
        [{"kind": mat.PHONG, "base_color": (0.8, 0.35, 0.1),
          "specular": (0.4, 0.4, 0.4), "phong_exp": 24.0}], device,
        prims=prim.make_prims(curve_prims(kind, samples_per_segment, swept),
                              device),
        lights=[{"kind": DIRECTIONAL, "direction": (-0.4, -0.8, -0.45),
                 "color": (0.9, 0.9, 0.9)},
                {"kind": AMBIENT, "color": (0.3, 0.3, 0.32)}],
        miss_color=(0.12, 0.12, 0.16))


def camera(width, height) -> Camera:
    return Camera(eye=(0, 0.2, 3.0), lookat=(0, 0, 0), fov_y=45,
                  aspect=width / height)


def render(width=512, height=512, samples=4, kind=cv.CUBIC_BSPLINE,
           swept=False, device="cuda", scene=None):
    """`samples` Whitted samples of depth 2 → (linear radiance [H, W, 3],
    Film, rays_traced)."""
    scene = scene if scene is not None else make_curve_scene(
        device, kind, swept=swept)
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
    p = argparse.ArgumentParser(description="curve primitives")
    p.add_argument("--file", default="curves.png")
    p.add_argument("--dim", default="512x512")
    p.add_argument("--kind", default=cv.CUBIC_BSPLINE, choices=KINDS)
    p.add_argument("--samples", type=int, default=8)
    p.add_argument("--swept", action="store_true",
                   help="the true swept spans instead of capsules "
                        "(quadratic / cubic B-spline, Catmull-Rom, Bézier)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.swept and args.kind == cv.LINEAR:
        args.kind = cv.QUADRATIC_BSPLINE
    w, h = parse_dim(args.dim)
    device = torch.device(args.device)
    t0 = time.perf_counter()
    accum, film, _ = render(w, h, samples=args.samples, kind=args.kind,
                            swept=args.swept, device=device)
    img = film_mod.make_color(accum).cpu().numpy()   # synchronises
    dt = time.perf_counter() - t0
    save_image(args.file, img)
    print(f"wrote {args.file} ({args.kind}{' swept' if args.swept else ''}, "
          f"{dt:.2f}s, on {device})")


if __name__ == "__main__":
    main()
