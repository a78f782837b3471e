"""Hair (counterpart of `apps/hair.py`): strands from a `.hair` file, or a
procedural fur patch, as capsules or swept spans, shaded by strand u,
segment u or strand index.

    python -m optix_raytracer_tpu_torch.apps.hair --file hair.ppm \\
        --dim 512x512 [--hair FILE.hair] [--spline cubic_bspline] [--swept]

Every camera ray is intersected against the whole prim table by torch ops
(`primitives.intersect_prims_closest`, in ray chunks of at most
`primitives.PLANE_ELEMS` ray-prim pairs); no triangle kernel runs. PNG
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
from ..core import rng as _rng
from ..core.camera import Camera, generate_rays
from ..io.image import save_image
from ._cli import parse_dim

SHADINGS = ("strand_u", "segment_u", "strand_idx")


def procedural_fur(num_strands=120, segs=6, seed=0):
    """A fur patch: strands from a disk, curling with noise from
    default_rng(seed) → (strand points list, strand radii list)."""
    rng = np.random.default_rng(seed)
    strands, radii = [], []
    for _ in range(num_strands):
        r = np.sqrt(rng.uniform(0, 1)) * 0.8
        phi = rng.uniform(0, 2 * np.pi)
        base = np.array([r * np.cos(phi), -0.5, r * np.sin(phi)])
        pts = [base]
        d = np.array([0.0, 1.0, 0.0])
        for _s in range(segs):
            d = d + 0.35 * rng.normal(size=3)
            d[1] = abs(d[1]) * 0.8 + 0.2
            d /= np.linalg.norm(d)
            pts.append(pts[-1] + 0.18 * d)
        strands.append(np.asarray(pts, np.float32))
        radii.append(np.linspace(0.012, 0.004, segs + 1).astype(np.float32))
    return strands, radii


def build_prims(strands, radii, device, spline=cv.LINEAR,
                samples_per_segment=4, swept=False):
    """The strands' prim table and each prim's strand index [P] int32:
    swept cubic spans for a cubic basis with `swept` (4 points or more),
    swept quadratic spans for any other with `swept` (3 or more), else
    capsules (through the evaluated spline past linear)."""
    descs, strand_of = [], []
    for si, (pts, rad) in enumerate(zip(strands, radii)):
        if swept and spline in (cv.CUBIC_BSPLINE, cv.CATMULL_ROM,
                                cv.BEZIER) and len(pts) >= 4:
            segs = cv.strand_to_swept_cubics(pts, rad, kind=spline, mat_id=0)
        elif swept and len(pts) >= 3:
            segs = cv.strand_to_swept_quads(pts, rad, mat_id=0)
        else:
            if spline != cv.LINEAR and len(pts) >= 4:
                pts, rad, _ = cv.eval_spline(pts, rad, spline,
                                             samples_per_segment)
            segs = cv.strand_to_capsules(pts, rad, mat_id=0)
        descs.extend(segs)
        strand_of.extend([si] * len(segs))
    return (prim.make_prims(descs, device),
            torch.as_tensor(np.asarray(strand_of, np.int32), device=device))


def shade(hits, strand_of, shading):
    """The three closest-hit shadings by the hit's u and strand, times a
    clamped n.l."""
    u = hits.uv[..., 0]
    if shading == "strand_u":        # green to red along the strand
        col = torch.stack([u, 1.0 - u, 0.2 * torch.ones_like(u)], -1)
    elif shading == "segment_u":     # u within each capsule
        col = torch.stack([u, u, torch.ones_like(u)], -1)
    else:                            # strand_idx: a hue from the strand id
        sid = strand_of[torch.clamp_min(hits.prim_id, 0).long()].to(
            torch.float32)
        h = torch.remainder(sid * 0.61803, 1.0)
        col = torch.stack([h, 1.0 - h, 0.5 + 0.5 * torch.sin(7.0 * h)], -1)
    light = torch.tensor([0.3, 0.8, 0.52], dtype=torch.float32,
                         device=u.device)
    n_dl = torch.clamp_min((hits.normal * light).sum(-1), 0.15)
    return col * n_dl[..., None]


def sample_radiance(prims, strand_of, shading, rays):
    """The radiance of flat camera rays [N]: the shading at the closest
    prim hit, the background on a miss → [N, 3]."""
    hits = prim.intersect_prims_closest(prims, rays)
    bg = torch.tensor([0.1, 0.1, 0.13], dtype=torch.float32,
                      device=rays.origin.device)
    return torch.where(hits.valid[:, None], shade(hits, strand_of, shading),
                       bg)


def camera(width, height) -> Camera:
    return Camera(eye=(0, 0.35, 2.6), lookat=(0, 0.15, 0), fov_y=40,
                  aspect=width / height)


def render(width=512, height=512, hair_file=None, shading="strand_u",
           spline=cv.LINEAR, samples=4, swept=False, device="cuda"):
    """→ (linear radiance [H, W, 3], Film)."""
    if hair_file:
        strands, radii = cv.load_hair_file(hair_file)
    else:
        strands, radii = procedural_fur()
    prims, strand_of = build_prims(strands, radii, device, spline,
                                   swept=swept)
    cam = camera(width, height).params(device)
    n = width * height
    film = film_mod.Film.create(height, width, device)
    for _ in range(samples):
        rng = _rng.seed(torch.arange(n, dtype=torch.int64, device=device),
                        film.subframe)
        rays, _ = generate_rays(cam, width, height,
                                rng_state=rng.reshape(height, width))
        radiance = sample_radiance(prims, strand_of, shading, rays.reshape(n))
        film = film.accumulate(radiance.reshape(height, width, 3))
    return film.accum, film


def main(argv=None):
    p = argparse.ArgumentParser(description="hair rendering")
    p.add_argument("--file", default="hair.png")
    p.add_argument("--hair", default=None, help=".hair input file")
    p.add_argument("--dim", default="512x512")
    p.add_argument("--shading", default="strand_u", choices=SHADINGS)
    p.add_argument("--spline", default=cv.LINEAR,
                   choices=[cv.LINEAR, cv.CUBIC_BSPLINE, cv.CATMULL_ROM])
    p.add_argument("--samples", type=int, default=4)
    p.add_argument("--swept", action="store_true",
                   help="swept spans instead of capsules (cubic for the "
                        "cubic bases, else quadratic)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    w, h = parse_dim(args.dim)
    device = torch.device(args.device)
    t0 = time.perf_counter()
    accum, film = render(w, h, hair_file=args.hair, shading=args.shading,
                         spline=args.spline, samples=args.samples,
                         swept=args.swept, device=device)
    img = film_mod.make_color(accum).cpu().numpy()   # synchronises
    dt = time.perf_counter() - t0
    save_image(args.file, img)
    print(f"wrote {args.file} ({args.shading}, {args.spline}"
          f"{', swept' if args.swept else ''}, {dt:.2f}s, on {device})")


if __name__ == "__main__":
    main()
