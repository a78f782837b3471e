"""Pluggable shading through direct and continuation callables dispatched by
a run-time SBT index (counterpart of `apps/callable_programs.py`, the
`optixCallablePrograms` sample).

Three direct callables (`__direct_callable__{phong,checkered,normal}_shade`,
`optixCallablePrograms.cu:36,75,101`) shade the sphere, selected by the
hitgroup record's `dc_index` through `optixDirectCall` (`:123`); a
continuation callable shades the miss from the ray direction
(`__continuation_callable__raydir_shade`, `:128`, called at `:138`). The
table is `api.CallableTable`, its index a tensor on the device: rewriting
it re-dispatches without a host read, as the reference's `--shade` cycling
rewrites the SBT record.

    python -m optix_raytracer_tpu_torch.apps.callable_programs --shade all \\
        --file callables.ppm

The sphere's hit and the shades are torch ops (the reference's XLA
arithmetic; no kernel).
"""
from __future__ import annotations

import argparse
import math
import time

import torch

from ..api.callables import CallableTable
from ..core import film
from ..core.camera import Camera, generate_rays
from ..io.image import save_image
from ._cli import parse_dim

SHADE_NAMES = ("phong", "checkered", "normal")

# Scene: a sphere, one point and one ambient light (the sample's).
SPHERE_RADIUS = 1.5
LIGHT_POS = (60.0, 40.0, 0.0)
LIGHT_COLOR = (1.0, 1.0, 1.0)
AMBIENT_COLOR = (0.4, 0.4, 0.4)


def _vec(v, like):
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _unit(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _dot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def phong_shade(hit_point, ray_dir, normal):
    """`__direct_callable__phong_shade` (optixCallablePrograms.cu:36-73)."""
    ka = _vec((0.2, 0.5, 0.5), normal)
    kd = _vec((0.2, 0.7, 0.8), normal)
    ks = _vec((0.9, 0.9, 0.9), normal)
    light = _vec(LIGHT_COLOR, normal)
    l = _unit(_vec(LIGHT_POS, normal) - hit_point)
    result = kd * _dot(normal, l) * light
    h = _unit(l - ray_dir)
    ndh = _dot(normal, h)
    result = result + torch.where(
        ndh > 0, ks * torch.pow(torch.clamp_min(ndh, 0.0), 64.0) * light, 0.0)
    return result + ka * _vec(AMBIENT_COLOR, normal)


def checkered_shade(hit_point, ray_dir, normal):
    """`__direct_callable__checkered_shade` (.cu:75-99): a polar checker on
    the sphere normal, lit by |n.d| against the ambient light."""
    value = torch.abs(_dot(normal, ray_dir))
    sn = _unit(hit_point)
    a = torch.arccos(torch.clamp(sn[..., 1:2], -1.0, 1.0))
    b = torch.atan2(sn[..., 0:1], sn[..., 2:3]) + math.pi
    check = ((torch.remainder(a, math.pi / 8) < math.pi / 16)
             ^ (torch.remainder(b, math.pi / 4) < math.pi / 8))
    ambient = _vec(AMBIENT_COLOR, normal)
    result = torch.where(check, ambient + value * 0.0, ambient + value * 1.0)
    return torch.clamp(result, 0.0, 1.0)


def normal_shade(hit_point, ray_dir, normal):
    """`__direct_callable__normal_shade` (.cu:101-104)."""
    return _unit(normal) * 0.5 + 0.5


def raydir_shade(ray_dir):
    """`__continuation_callable__raydir_shade` (.cu:128-132): the miss
    program's background, from the ray direction."""
    return (ray_dir + 1.0) * 0.5 * 0.3


def radiance(width=768, height=768, shade: int = 0, device="cuda"):
    """The image with direct callable `shade` as linear radiance [H, W, 3]
    on `device`; the index lives on the device."""
    table = CallableTable([phong_shade, checkered_shade, normal_shade])
    miss_table = CallableTable([raydir_shade])
    cam = Camera(eye=(0.0, 0.0, 4.0), lookat=(0.0, 0.0, 0.0), fov_y=60.0,
                 aspect=width / height).params(device)
    dc_index = torch.tensor(shade, dtype=torch.int32, device=device)
    rays, _ = generate_rays(cam, width, height, jitter=False)
    flat = rays.reshape(width * height)
    o, d = flat.origin, flat.direction
    # the sample's one-sphere GAS: closest hit of a centred sphere
    b = torch.sum(o * d, dim=-1)
    cc = torch.sum(o * o, dim=-1) - SPHERE_RADIUS ** 2
    disc = b * b - cc
    t = -b - torch.sqrt(torch.clamp_min(disc, 0.0))
    hit = (disc >= 0.0) & (t > 1e-3)
    p = o + t[:, None] * d
    n = p / SPHERE_RADIUS
    # __closesthit__radiance: optixDirectCall(dc_index, hit, dir, n)
    lit = table.direct_call(dc_index, p, d, n)
    # __miss__raydir: optixContinuationCall(0, ray_dir)
    bg = miss_table.continuation_call(torch.zeros_like(dc_index), d)
    return torch.where(hit[:, None], lit, bg).reshape(height, width, 3)


def render(width=768, height=768, shade: int = 0, device="cuda"):
    """→ uint8 RGBA [H, W, 4] on `device`."""
    return film.make_color(radiance(width, height, shade, device))


def main(argv=None):
    p = argparse.ArgumentParser(
        description="direct / continuation callables (optixCallablePrograms)")
    p.add_argument("--file", default="callable_programs.png")
    p.add_argument("--dim", default="768x768")
    p.add_argument("--shade", choices=SHADE_NAMES + ("all",),
                   default="phong",
                   help="which direct callable shades the sphere; 'all' "
                        "writes one image per callable (the window's "
                        "cycling)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    w, h = parse_dim(args.dim)
    kinds = SHADE_NAMES if args.shade == "all" else (args.shade,)
    for name in kinds:
        t0 = time.perf_counter()
        img = render(w, h, shade=SHADE_NAMES.index(name),
                     device=torch.device(args.device)).cpu().numpy()
        dt = time.perf_counter() - t0
        out = args.file
        if len(kinds) > 1:
            stem, dot, ext = args.file.rpartition(".")
            out = f"{stem}_{name}{dot}{ext}" if dot else f"{out}_{name}"
        save_image(out, img)
        print(f"wrote {out} ({w}x{h}, dc_index={SHADE_NAMES.index(name)}, "
              f"{dt:.3f}s, on {args.device})")


if __name__ == "__main__":
    main()
