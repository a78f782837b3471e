"""A user intersection program over a custom AABB primitive (counterpart
of `apps/custom_primitive.py`, the `optixCustomPrimitive` sample): the app
registers a custom AABB build input and its own `__intersection__is`
sphere (`optixCustomPrimitive.cpp:410-411`) and shades the world-space
normal n * 0.5 + 0.5 (`optixCustomPrimitive.cu:127-135`).

    python -m optix_raytracer_tpu_torch.apps.custom_primitive --file cp.ppm

As in the reference, the intersection program is the app's own code:
`user_intersection` and the AABB gate `aabb_gate` are plain torch here, and
the app launches no kernel of the port.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..core import film
from ..core.camera import Camera, generate_rays
from ..io.image import save_image
from ._cli import parse_dim

SPHERE_CENTER = (0.0, 0.0, 0.0)
SPHERE_RADIUS = 1.5


def user_intersection(o, d, tmin, tmax):
    """The app's `__intersection__is`: the nearest root of the ray / sphere
    quadratic inside [tmin, tmax] → (t, hit), the contract of
    `optixReportIntersection`."""
    c = torch.as_tensor(SPHERE_CENTER, dtype=torch.float32, device=o.device)
    oc = o - c
    b = torch.sum(oc * d, dim=-1)
    cc = torch.sum(oc * oc, dim=-1) - SPHERE_RADIUS * SPHERE_RADIUS
    disc = b * b - cc
    s = torch.sqrt(torch.clamp_min(disc, 0.0))
    t0, t1 = -b - s, -b + s
    t = torch.where((t0 >= tmin) & (t0 <= tmax), t0, t1)
    hit = (disc >= 0.0) & (t >= tmin) & (t <= tmax)
    return t, hit


def aabb_gate(o, d, tmin, tmax, lo, hi):
    """The slab test against the primitive's box (the custom build input,
    `optix_types.h:925`): the user program runs only for rays whose segment
    crosses it."""
    inv = 1.0 / torch.where(torch.abs(d) < 1e-12, 1e-12, d)
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    near = torch.amax(torch.minimum(t0, t1), dim=-1)
    far = torch.amin(torch.maximum(t0, t1), dim=-1)
    return (far >= torch.maximum(near, tmin)) & (near <= tmax)


def radiance(width=768, height=768, device="cuda"):
    """The frame as linear radiance [H, W, 3] on `device`."""
    cam = Camera(eye=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 0.0), fov_y=60.0,
                 aspect=width / height).params(device)
    center = torch.as_tensor(SPHERE_CENTER, dtype=torch.float32,
                             device=device)
    lo, hi = center - SPHERE_RADIUS, center + SPHERE_RADIUS
    rays, _ = generate_rays(cam, width, height, jitter=False)
    flat = rays.reshape(width * height)
    o, d = flat.origin, flat.direction
    crosses = aabb_gate(o, d, flat.tmin, flat.tmax, lo, hi)
    t, hit = user_intersection(o, d, flat.tmin, flat.tmax)
    hit = hit & crosses
    p = o + t[:, None] * d
    n = (p - center) / SPHERE_RADIUS
    out = torch.where(hit[:, None], n * 0.5 + 0.5, 0.0)   # the closest hit
    return out.reshape(height, width, 3)


def render(width=768, height=768, device="cuda"):
    """→ uint8 RGBA [H, W, 4] on `device`."""
    return film.make_color(radiance(width, height, device))


def main(argv=None):
    p = argparse.ArgumentParser(
        description="custom AABB primitive + user IS (optixCustomPrimitive)")
    p.add_argument("--file", default="custom_primitive.png")
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
