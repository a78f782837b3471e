"""Progressive Cornell-box path tracer (counterpart of `apps/pathtracer.py`).

    python -m optix_raytracer_tpu_torch.apps.pathtracer --file cornell.ppm \\
        --dim 1920x1088 --samples 32 --launch-samples 16 --depth 4
    python -m optix_raytracer_tpu_torch.apps.pathtracer --scene spd-tetra \\
        --file tetra.ppm --dim 1920x1088 --samples 32 --launch-samples 16

On a CUDA device each launch of the Cornell box is one fused-kernel launch
(kernel 3); `--scene spd-tetra`, the SPD `tetra` pyramid of 7 levels
(65,538 triangles), takes the cluster path (kernels 4-6), in sample-major
strips from 8 samples a launch, else the sorted sequential loop. With
`--denoise` the primary-hit guide layers (`render_aovs`: albedo, normal,
emission; kernel 1) feed the denoiser (`api.denoiser.Denoiser`, the
trained net) before the frame is encoded; `--ascii` prints a preview. PNG
output needs Pillow; .ppm needs nothing beyond numpy.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..core import film as film_mod
from ..io.image import save_image, to_ascii
from ..scene.builtins import (cornell_box, cornell_camera, spd_tetra_camera,
                              spd_tetra_scene)
from ..wavefront.engine import render_accumulate
from ._cli import parse_dim


def render(width=768, height=768, samples=16, max_depth=4, chunk_size=65536,
           scene=None, camera=None, film=None, samples_per_launch=None,
           device="cuda"):
    """Render on `device` → (linear radiance [H, W, 3], Film, rays_traced)."""
    scene = scene if scene is not None else cornell_box(device)
    cam = (camera if camera is not None
           else cornell_camera(width, height)).params(device)
    film = film if film is not None else film_mod.Film.create(height, width,
                                                              device)
    spl = samples_per_launch or samples
    rays = torch.zeros((), dtype=torch.int64, device=device)
    done = 0
    while done < samples:
        step = min(spl, samples - done)
        film, r = render_accumulate(scene, cam, film, width, height,
                                    samples_per_launch=step,
                                    max_depth=max_depth,
                                    chunk_size=chunk_size)
        rays = rays + r
        done += step
    return film.accum, film, rays


SCENES = {"cornell": (cornell_box, cornell_camera),
          "spd-tetra": (spd_tetra_scene, spd_tetra_camera)}


def main(argv=None):
    p = argparse.ArgumentParser(description="Cornell-box path tracer")
    p.add_argument("--scene", default="cornell", choices=sorted(SCENES))
    p.add_argument("--file", default="cornell.png")
    p.add_argument("--dim", default="768x768")
    p.add_argument("--samples", type=int, default=64)
    p.add_argument("--launch-samples", type=int, default=16,
                   help="samples per launch (reference default 16)")
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--ascii", action="store_true")
    p.add_argument("--denoise", action="store_true",
                   help="denoise with the albedo / normal / emission guides "
                        "(the optixDenoiser post-pass)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    w, h = parse_dim(args.dim)
    device = torch.device(args.device)

    t0 = time.perf_counter()
    make_scene, make_camera = SCENES[args.scene]
    scene = make_scene(device)
    camera = make_camera(w, h)
    accum, film, rays = render(w, h, samples=args.samples,
                               max_depth=args.depth, scene=scene,
                               camera=camera,
                               samples_per_launch=args.launch_samples,
                               device=device)
    if args.denoise:
        from ..api.denoiser import Denoiser
        from ..wavefront.engine import render_aovs
        aovs = render_aovs(scene, camera.params(device), w, h)
        accum = Denoiser(device=device).setup(w, h).invoke(
            accum, albedo=aovs["albedo"], normal=aovs["normal"],
            emission=aovs["emission"])
    img = film_mod.make_color(accum).cpu().numpy()   # synchronises
    dt = time.perf_counter() - t0
    save_image(args.file, img)
    if args.ascii:
        print(to_ascii(img))
    print(f"wrote {args.file} ({w}x{h}, {args.samples} spp, {dt:.2f}s, "
          f"{int(rays) / dt / 1e6:.2f} Mrays/s, "
          f"{w * h * args.samples / dt / 1e6:.2f} Msamples/s, on {device})")


if __name__ == "__main__":
    main()
