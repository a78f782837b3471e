"""A displaced micromesh (counterpart of `apps/displaced_micromesh.py`):
two base triangles subdivided 4^level ways at build time and displaced
along +y by a bump function (accel/micromap.displace_mesh), the dense mesh
rendered by the Whitted integrator under a directional and an ambient
light.

    python -m optix_raytracer_tpu_torch.apps.displaced_micromesh \\
        --file micromesh.ppm --dim 512x512 --level 4 --samples 4

At level 4 the mesh has 2 x 4^4 = 512 triangles and runs on kernels 1-2;
past 512 it takes its cluster table (kernels 4-6), where the reference
passes with_bvh.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..accel.micromap import displace_mesh
from ..core import film as film_mod
from ..core.camera import Camera
from ..io.image import save_image
from ..scene.device_scene import make_device_scene
from ..shade import materials as mat
from ..shade.lights import AMBIENT, DIRECTIONAL
from ..wavefront.whitted import render_whitted
from ._cli import parse_dim

LIGHTS = [
    {"kind": DIRECTIONAL, "direction": (-0.5, -0.8, -0.3),
     "color": (0.95, 0.9, 0.8)},
    {"kind": AMBIENT, "color": (0.2, 0.22, 0.28)},
]


def make_displaced_plane(level=4):
    """The [-1, 1]² plane's two triangles at `level`, bumped along +y by
    0.22 sin(3.5 x) cos(3.1 z) + 0.08 sin(9 x + 4 z) → (vertices,
    indices)."""
    verts = np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]],
                     np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    up = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))

    def bumps(points, bary):
        x, z = points[:, 0], points[:, 2]
        return (0.22 * np.sin(3.5 * x) * np.cos(3.1 * z)
                + 0.08 * np.sin(9.0 * x + 4.0 * z)).astype(np.float32)

    return displace_mesh(verts, idx, bumps, directions=up, level=level)


def make_scene(level, device):
    verts, idx = make_displaced_plane(level)
    return make_device_scene(
        verts, idx, np.zeros(len(idx), np.int32),
        [{"kind": mat.DIFFUSE, "base_color": (0.55, 0.5, 0.45)}], device,
        lights=LIGHTS, miss_color=(0.2, 0.25, 0.38))


def camera(width, height) -> Camera:
    return Camera(eye=(1.8, 1.4, 2.2), lookat=(0, 0, 0), fov_y=40,
                  aspect=width / height)


def render(width=512, height=512, level=4, samples=4, device="cuda"):
    """`samples` Whitted samples at depth 2 → (linear radiance [H, W, 3],
    the number of micro-triangles, rays_traced)."""
    scene = make_scene(level, device)
    film, rays = render_whitted(scene, camera(width, height).params(
        scene.device), width, height, samples, max_depth=2)
    return film.accum, scene.num_triangles, rays


def main(argv=None):
    p = argparse.ArgumentParser(description="displaced micromesh")
    p.add_argument("--file", default="micromesh.png")
    p.add_argument("--dim", default="512x512")
    p.add_argument("--level", type=int, default=4,
                   help="subdivision level (4^level micro-tris per base)")
    p.add_argument("--samples", type=int, default=4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    w, h = parse_dim(args.dim)
    device = torch.device(args.device)
    t0 = time.perf_counter()
    accum, n_tris, rays = render(w, h, level=args.level,
                                 samples=args.samples, device=device)
    img = film_mod.make_color(accum).cpu().numpy()   # synchronises
    dt = time.perf_counter() - t0
    save_image(args.file, img)
    print(f"wrote {args.file} ({n_tris} micro-triangles, level "
          f"{args.level}, {dt:.2f}s, {int(rays) / dt / 1e6:.2f} Mrays/s, "
          f"on {device})")


if __name__ == "__main__":
    main()
