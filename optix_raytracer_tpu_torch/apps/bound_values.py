"""Launch-parameter specialisation at module creation (counterpart of
`apps/bound_values.py`, the `optixBoundValues` sample).

The path tracer's `light_samples` launch parameter is baked into the module
with `OptixModuleCompileBoundValueEntry` (`optixBoundValues.cpp:742-750`),
so the NEE loop runs with a constant bound instead of reading the params.
Here a bound value is a Python int given to the raygen by `api.Module`'s
bound_values; the runtime parameter is an int tensor on the device that
the loop reads back to the host first. The image is the same either way
(`--compare` checks it).

Direct lighting of the Cornell box at each camera ray's first hit: per
light sample a point on the area light from `jax.random`'s draws (key 7,
folded with the sample index; `core/threefry.py` gives the same bits) and
a shadow query. On CUDA the camera and shadow queries run kernels 1-2.

    python -m optix_raytracer_tpu_torch.apps.bound_values --compare \\
        --file bound_values.ppm
"""
from __future__ import annotations

import argparse
import math
import time

import torch

from ..api.module import Module
from ..core import film
from ..core import threefry
from ..core.camera import generate_rays
from ..core.rays import Rays
from ..io.image import save_image
from ..scene.builtins import cornell_box, cornell_camera
from ..wavefront.intersect import scene_any, scene_closest
from ._cli import parse_dim

SHADOW_EPS = 1e-2


def _nee_sample(scene, p, n, albedo, key, i: int):
    """One area-light sample from hit points p (optixPathTracer.cu:
    382-409; bound_values.py:37-56)."""
    light = scene.area_light
    u = threefry.uniform(threefry.fold_in(key, i), (2, p.shape[0]))
    lp = light.corner + u[0][:, None] * light.v1 + u[1][:, None] * light.v2
    to_l = lp - p
    dist = torch.linalg.vector_norm(to_l, dim=-1)
    wi = to_l / torch.clamp_min(dist, 1e-8)[:, None]
    ndl = torch.clamp_min(torch.sum(n * wi, dim=-1), 0.0)
    lndl = torch.abs(torch.sum(light.normal * wi, dim=-1))
    shadow = Rays(origin=p + SHADOW_EPS * wi, direction=wi,
                  tmin=torch.zeros_like(dist), tmax=dist - 2 * SHADOW_EPS)
    occluded = scene_any(scene, shadow)
    w = torch.where(occluded, 0.0,
                    light.area * ndl * lndl
                    / torch.clamp_min(dist * dist, 1e-8) / math.pi)
    return albedo * light.emission * w[:, None]


def make_raygen(scene, width, height):
    def raygen(cam, light_samples=None, *, bound_light_samples=None):
        """Direct-lighting raygen → linear radiance [H, W, 3].
        `light_samples`: an int tensor on the device (the runtime launch
        parameter); `bound_light_samples`: a Python int baked in as a
        module bound value."""
        rays, _ = generate_rays(cam, width, height, jitter=False)
        flat = rays.reshape(width * height)
        hits = scene_closest(scene, flat)
        p = flat.origin + hits.t[:, None] * flat.direction
        n = hits.normal
        mat = torch.clamp_min(hits.mat_id, 0).long()
        albedo = scene.materials.base_color[mat]
        key = threefry.prng_key(7, p.device)
        acc = torch.zeros_like(p)
        if bound_light_samples is not None:       # the specialised module
            count = bound_light_samples
        else:                                     # the runtime parameter
            count = int(light_samples)            # a host read
        # the mean divides by a device tensor either way: on CUDA a Python
        # divisor would multiply by its reciprocal and round apart
        ls = torch.full((), float(count), dtype=torch.float32,
                        device=p.device)
        for i in range(count):
            acc = acc + _nee_sample(scene, p, n, albedo, key, i)
        emitted = scene.materials.emission[mat]
        out = torch.where(hits.valid[:, None], emitted + acc / ls, 0.0)
        return out.reshape(height, width, 3)
    return raygen


def render(width=512, height=512, light_samples=4, bound=True,
           device="cuda"):
    """→ (uint8 RGBA [H, W, 4], the raygen callable)."""
    scene = cornell_box(device)
    cam = cornell_camera(width, height).params(device)
    raygen = make_raygen(scene, width, height)
    if bound:
        mod = Module({"__raygen__rg": raygen},
                     bound_values={"bound_light_samples": light_samples},
                     name="bound_values")
        fn = mod.get("__raygen__rg")
        return film.make_color(fn(cam)), fn
    ls = torch.tensor(light_samples, dtype=torch.int32, device=device)
    return film.make_color(raygen(cam, ls)), raygen


def main(argv=None):
    p = argparse.ArgumentParser(
        description="bound-value module specialisation (optixBoundValues)")
    p.add_argument("--file", default="bound_values.png")
    p.add_argument("--dim", default="512x512")
    p.add_argument("--light-samples", type=int, default=4,
                   help="NEE samples per hit (the bound launch param)")
    p.add_argument("--no-bound", action="store_true",
                   help="keep light_samples a runtime launch param "
                        "(the reference's unspecialised module)")
    p.add_argument("--compare", action="store_true",
                   help="run both modules, require identical images, "
                        "report times")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    w, h = parse_dim(args.dim)
    device = torch.device(args.device)
    if args.compare:
        imgs = {}
        for bound in (True, False):
            t0 = time.perf_counter()
            img, _ = render(w, h, args.light_samples, bound=bound,
                            device=device)
            imgs["bound" if bound else "runtime"] = img.cpu().numpy()
            print(f"{'bound' if bound else 'runtime':8s} first call + "
                  f"render {time.perf_counter() - t0:.3f}s")
        if not (imgs["bound"] == imgs["runtime"]).all():
            raise SystemExit("bound != runtime image")
        print("bound and runtime images identical")
        img = imgs["bound"]
    else:
        img, _ = render(w, h, args.light_samples, bound=not args.no_bound,
                        device=device)
        img = img.cpu().numpy()
    save_image(args.file, img)
    print(f"wrote {args.file} ({w}x{h}, light_samples={args.light_samples}, "
          f"{'runtime' if args.no_bound else 'bound'}, on {device})")


if __name__ == "__main__":
    main()
