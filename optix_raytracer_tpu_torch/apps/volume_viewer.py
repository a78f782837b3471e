"""Fog volume viewer (counterpart of `apps/volume_viewer.py`): a density
grid marched in fixed steps, lit by a directional light through a shadow
sweep, composited over a diffuse floor; or with `--engine` a cloud inside
the Cornell box through the main path tracer (scatter points, shadow
queries and transmittance-weighted NEE).

    python -m optix_raytracer_tpu_torch.apps.volume_viewer --file volume.ppm \\
        --dim 512x512 [--grid FILE.nvdb [--grid-name NAME]] [--engine]

The grid is a NanoVDB fog volume read by the port's codec
(`io/nanovdb.py`), or the procedural puffball. The standalone march and
its floor (a custom prim) are torch ops; with `--engine` the Cornell box's
closest, NEE and scatter shadow queries run kernels 1-2 on a CUDA device.
PNG output needs Pillow; .ppm needs nothing beyond numpy.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..accel import primitives as prim
from ..accel import volume as vol
from ..core import film as film_mod
from ..core import rng as _rng
from ..core.camera import Camera, generate_rays
from ..io.image import save_image
from ..scene import builtins as B
from ..scene.device_scene import DeviceScene, make_device_scene
from ..shade.lights import ParallelogramLight
from ..wavefront.engine import render_accumulate
from ._cli import parse_dim

LIGHT_DIR = (-0.5, -0.8, -0.33)
LIGHT_COLOR = (1.0, 0.95, 0.85)


def march_rays(grid, floor_prims, rays, num_steps=96):
    """Flat camera rays [N]: the floor lit by the light, then the march over
    it → radiance [N, 3]."""
    hits = prim.intersect_prims_closest(floor_prims, rays)

    def c(*v):
        return torch.tensor(v, dtype=torch.float32, device=rays.origin.device)

    ld = c(*LIGHT_DIR)
    ld = ld / torch.linalg.vector_norm(ld)
    ndl = torch.clamp_min((-ld * hits.normal).sum(-1), 0.0)
    bg = torch.where(hits.valid[:, None],
                     c(0.45, 0.42, 0.38) * (0.15 + 0.85 * ndl[:, None]),
                     c(0.25, 0.35, 0.55))
    bg_t = torch.where(hits.valid, hits.t, rays.tmax)
    rad, _ = vol.march(grid, rays, LIGHT_DIR, LIGHT_COLOR, sigma_t=10.0,
                       num_steps=num_steps, bg_radiance=bg, bg_t=bg_t)
    return rad


def render_sample(grid, floor_prims, cam, width, height, subframe,
                  num_steps=96):
    """One sample of the standalone march → radiance [H, W, 3]."""
    dev = cam["eye"].device
    n = width * height
    if isinstance(subframe, torch.Tensor):
        subframe = subframe.to(dev)
    rng = _rng.seed(torch.arange(n, dtype=torch.int64, device=dev), subframe)
    rays, _ = generate_rays(cam, width, height,
                            rng_state=rng.reshape(height, width))
    return march_rays(grid, floor_prims, rays.reshape(n),
                      num_steps).reshape(height, width, 3)


def _normalized_grid(grid: vol.DensityGrid) -> vol.DensityGrid:
    """A loaded grid rescaled to the viewer's stage: its longest world edge
    2 units, centred in x and z, resting just above y = -1."""
    span = grid.hi - grid.lo
    s = 2.0 / torch.max(span)
    half = span * s * 0.5
    lo = torch.stack([-half[0], torch.full_like(half[0], -1.0 + 0.02),
                      -half[2]])
    return vol.DensityGrid(density=grid.density, lo=lo, hi=lo + span * s)


def load_grid(path, grid_name=None, res: int = 64, device="cuda"):
    """The stage's grid: a .nvdb fog volume, normalised, or the procedural
    puffball of res³ voxels."""
    if path:
        from ..io.nanovdb import load_density_grid
        return _normalized_grid(load_density_grid(path, grid_name,
                                                  device=device))
    return vol.pyroclastic_ball(res=res, device=device)


def floor(device):
    return prim.make_prims([
        {"kind": prim.PARALLELOGRAM, "anchor": (-6.0, -1.05, -6.0),
         "v1": (12.0, 0, 0), "v2": (0, 0, 12.0)}], device)


def camera(width, height) -> Camera:
    return Camera(eye=(2.2, 0.8, 3.2), lookat=(0, -0.1, 0), fov_y=40,
                  aspect=width / height)


def render(width=512, height=512, samples=4, res=64, num_steps=96,
           grid_file=None, grid_name=None, device="cuda"):
    """The standalone march → (linear radiance [H, W, 3], Film)."""
    grid = load_grid(grid_file, grid_name, res=res, device=device)
    floor_prims = floor(device)
    cam = camera(width, height).params(device)
    film = film_mod.Film.create(height, width, device)
    for _ in range(samples):
        film = film.accumulate(render_sample(grid, floor_prims, cam, width,
                                             height, film.subframe,
                                             num_steps=num_steps))
    return film.accum, film


def engine_scene(device, res=48, grid_file=None,
                 grid_name=None) -> DeviceScene:
    """The Cornell box with the grid scaled into it (its longest edge 280
    units from (140, 80, 150)), sigma_t 0.02, albedo 0.95."""
    verts, idx, tri_mat = B.quads_to_triangles(B._CORNELL_QUADS)
    ball = load_grid(grid_file, grid_name, res=res, device=device)
    span = ball.hi - ball.lo
    top = torch.max(span)
    s = torch.full_like(top, 280.0) / top
    lo = torch.tensor([140.0, 80.0, 150.0], dtype=torch.float32,
                      device=device)
    cloud = vol.DensityGrid(density=ball.density, lo=lo, hi=lo + span * s)
    light = ParallelogramLight.make(B.CORNELL_LIGHT_CORNER, B.CORNELL_LIGHT_V1,
                                    B.CORNELL_LIGHT_V2,
                                    B.CORNELL_LIGHT_EMISSION, device)
    return make_device_scene(verts, idx, tri_mat, B.CORNELL_MATERIALS, device,
                             area_light=light, volume=cloud,
                             volume_sigma=0.02, volume_albedo=0.95)


def render_engine(width, height, samples, res=48, max_depth=3,
                  grid_file=None, grid_name=None, device="cuda"):
    """The cloud in the Cornell box, `samples` samples in one launch →
    (linear radiance [H, W, 3], Film, rays_traced)."""
    scene = engine_scene(device, res, grid_file, grid_name)
    cam = B.cornell_camera(width, height).params(device)
    film = film_mod.Film.create(height, width, device)
    film, rays = render_accumulate(scene, cam, film, width, height,
                                   samples_per_launch=samples,
                                   max_depth=max_depth, chunk_size=None)
    return film.accum, film, rays


def main(argv=None):
    p = argparse.ArgumentParser(description="fog volume viewer")
    p.add_argument("--file", default="volume.png")
    p.add_argument("--dim", default="512x512")
    p.add_argument("--res", type=int, default=64, help="grid resolution")
    p.add_argument("--steps", type=int, default=96)
    p.add_argument("--samples", type=int, default=4)
    p.add_argument("--grid", default=None, metavar="FILE.nvdb",
                   help="NanoVDB fog-volume file (default: the procedural "
                        "puffball)")
    p.add_argument("--grid-name", default=None,
                   help="the grid to take from a multi-grid .nvdb")
    p.add_argument("--engine", action="store_true",
                   help="the cloud inside the Cornell box through the main "
                        "path tracer")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    w, h = parse_dim(args.dim)
    device = torch.device(args.device)
    t0 = time.perf_counter()
    if args.engine:
        accum, film, _ = render_engine(w, h, args.samples,
                                       res=min(args.res, 64),
                                       grid_file=args.grid,
                                       grid_name=args.grid_name,
                                       device=device)
        what = "engine: Cornell + cloud"
    else:
        accum, film = render(w, h, samples=args.samples, res=args.res,
                             num_steps=args.steps, grid_file=args.grid,
                             grid_name=args.grid_name, device=device)
        what = f"{args.grid or f'grid {args.res}^3'}, {args.steps} steps"
    img = film_mod.make_color(accum).cpu().numpy()   # synchronises
    dt = time.perf_counter() - t0
    save_image(args.file, img)
    print(f"wrote {args.file} ({what}, {dt:.2f}s, on {device})")


if __name__ == "__main__":
    main()
