"""Alpha cutouts on the Cornell scene (counterpart of `apps/cutouts.py`):
the tall block is cut by a checker mask, the short block by a circle mask,
both honoured by radiance and shadow rays.

    python -m optix_raytracer_tpu_torch.apps.cutouts --file cutouts.ppm \\
        --dim 768x768 --samples 32

The scene has 32 triangles, so on a CUDA device its queries run kernels
1-2: radiance rays through the wavefront's cut lanes, shadow rays through
the opacity micromaps (one any-hit query over the certain-solid triangles,
then the re-entry loop over the unknown ones). PNG output needs Pillow;
.ppm needs nothing beyond numpy.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..core import film as film_mod
from ..io.image import save_image
from ..scene import builtins
from ..scene.device_scene import DeviceScene
from ..wavefront.engine import render_accumulate
from ._cli import parse_dim


def cutout_cornell(device, **kw) -> DeviceScene:
    """The Cornell box with the checker-cut tall block and the circle-cut
    short block (builtins.cutout_cornell_parts); kw to make_device_scene
    (opacity_micromaps=False leaves the micromaps out)."""
    return builtins.scene_from_parts(builtins.cutout_cornell_parts(), device,
                                     **kw)


def cutout_grid(device, nx=40, ny=30, **kw) -> DeviceScene:
    """The cluster-scene cutout grid (builtins.cutout_grid_parts): 2 nx ny
    + 2 triangles, every micromap summary certain."""
    return builtins.scene_from_parts(builtins.cutout_grid_parts(nx, ny),
                                     device, **kw)


def opaque_alpha_cornell(device, **kw) -> DeviceScene:
    """bench.py's certain-alpha Cornell box: both blocks alpha-masked, never
    a hole (builtins.opaque_alpha_cornell_parts)."""
    return builtins.scene_from_parts(builtins.opaque_alpha_cornell_parts(),
                                     device, **kw)


def textured_cutout_cornell(device, **kw) -> DeviceScene:
    """The cutout Cornell with its tall block cut by a base map's alpha
    (builtins.textured_cutout_cornell_parts)."""
    return builtins.scene_from_parts(
        builtins.textured_cutout_cornell_parts(), device, **kw)


def render(width=768, height=768, samples=16, max_depth=4, scene=None,
           device="cuda"):
    """`samples` samples in one launch on `device` → (linear radiance
    [H, W, 3], Film, rays_traced)."""
    scene = scene if scene is not None else cutout_cornell(device)
    cam = builtins.cornell_camera(width, height).params(scene.device)
    film = film_mod.Film.create(height, width, scene.device)
    film, rays = render_accumulate(scene, cam, film, width, height,
                                   samples_per_launch=samples,
                                   max_depth=max_depth)
    return film.accum, film, rays


def main(argv=None):
    p = argparse.ArgumentParser(description="alpha cutouts")
    p.add_argument("--file", default="cutouts.png")
    p.add_argument("--dim", default="768x768")
    p.add_argument("--samples", type=int, default=32)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    w, h = parse_dim(args.dim)
    device = torch.device(args.device)
    t0 = time.perf_counter()
    accum, film, rays = render(w, h, samples=args.samples, device=device)
    img = film_mod.make_color(accum).cpu().numpy()   # synchronises
    dt = time.perf_counter() - t0
    save_image(args.file, img)
    print(f"wrote {args.file} ({w}x{h}, {int(film.subframe)} spp, "
          f"{dt:.2f}s, {int(rays) / dt / 1e6:.2f} Mrays/s, on {device})")


if __name__ == "__main__":
    main()
