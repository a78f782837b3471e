"""Headless ray casting as a compute service (counterpart of
`apps/raycasting.py`, the `optixRaycasting` sample): no camera and no
display; the app hands the tracer a buffer of rays and takes hits back
(`optixRaycastingKernels.h:35-47`), with helpers that make an orthographic
ray grid over the scene's box, translate a ray set and shade hits
(`createRaysOrthoOnDevice` / `translateRaysOnDevice` /
`shadeHitsOnDevice`), and two ray sets, the scene and a translated copy,
on "two streams" (`optixRaycasting.cpp:294-311`).

    python -m optix_raytracer_tpu_torch.apps.raycasting --file rc.ppm
    python -m optix_raytracer_tpu_torch.apps.raycasting --model model.glb \\
        --file rc.ppm --measure-overlap

The queries are `scene_closest`: kernel 1 on the Cornell box, kernels 4-5 on
a model past 512 triangles, on a CUDA device (their plain versions on the
CPU). torch's CUDA launches return before the card finishes, as JAX's
dispatch does, so `--measure-overlap` times the two sets launched with a
sync between them against both left in flight.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core.rays import Hits, Rays
from ..io.image import save_image
from ..scene.device_scene import DeviceScene
from ..wavefront.intersect import scene_closest
from ._cli import parse_dim

# The Cornell box's bounds (apps/raycasting.py:101).
CORNELL_BOX = (np.array([0, 0, 0.]), np.array([556, 548.8, 559.2]))


def create_rays_ortho(width: int, height: int, bbox_lo, bbox_hi,
                      padding: float = 0.05, device="cuda") -> Rays:
    """An orthographic grid of rays over the box, looking down -z
    (`createRaysOrthoOnDevice`) → Rays [height * width]."""
    lo = torch.as_tensor(np.asarray(bbox_lo), dtype=torch.float32,
                         device=device)
    hi = torch.as_tensor(np.asarray(bbox_hi), dtype=torch.float32,
                         device=device)
    pad = (hi - lo) * padding
    lo_p, hi_p = lo - pad, hi + pad
    fw = torch.full((), width, dtype=torch.float32, device=device)
    fh = torch.full((), height, dtype=torch.float32, device=device)
    xs = lo_p[0] + (torch.arange(width, device=device) + 0.5) / fw * (
        hi_p[0] - lo_p[0])
    ys = lo_p[1] + (torch.arange(height, device=device) + 0.5) / fh * (
        hi_p[1] - lo_p[1])
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    origin = torch.stack([gx, gy, torch.full_like(gx, 0.0) + (hi_p[2] + 1.0)],
                         dim=-1)
    direction = torch.tensor([0.0, 0.0, -1.0],
                             device=device).expand(origin.shape)
    n = width * height
    return Rays.make(origin.reshape(n, 3), direction.reshape(n, 3),
                     tmin=0.0, tmax=1e16)


def translate_rays(rays: Rays, offset) -> Rays:
    """`translateRaysOnDevice`: the ray set shifted by a vector."""
    off = torch.as_tensor(np.asarray(offset, np.float32),
                          device=rays.origin.device)
    return Rays(origin=rays.origin + off, direction=rays.direction,
                tmin=rays.tmin, tmax=rays.tmax)


def shade_hits(hits: Hits):
    """`shadeHitsOnDevice`: the normal as colour where a ray hits, black
    where it misses → [N, 3]."""
    return torch.where(hits.valid[:, None], hits.normal * 0.5 + 0.5, 0.0)


def cast(scene: DeviceScene, rays: Rays) -> Hits:
    """The service's entry point: rays in, closest hits out."""
    return scene_closest(scene, rays)


def build(model, device):
    """→ (DeviceScene, lo, hi): the model's (`Scene.load`) or the Cornell
    box."""
    if model:
        from ..scene.scene import Scene
        host = Scene.load(model)
        lo, hi = host.aabb()
        return host.finalize(device), lo, hi
    from ..scene.builtins import cornell_box
    return cornell_box(device), *CORNELL_BOX


def render(scene: DeviceScene, lo, hi, width=512, height=512):
    """Both ray sets side by side → (float [H, 2W, 3] on the scene's device,
    the rays, the offset of the second set)."""
    rays = create_rays_ortho(width, height, lo, hi, device=scene.device)
    off = (0.25 * (hi - lo)[0], 0, 0)
    img_a = shade_hits(cast(scene, rays)).reshape(height, width, 3)
    img_b = shade_hits(cast(scene, translate_rays(rays, off))).reshape(
        height, width, 3)
    return torch.cat([img_a, img_b], dim=1), rays, off


def measure_overlap(scene: DeviceScene, rays: Rays, off, reps: int = 5):
    """(serialised, in flight) seconds of `reps` pairs of casts: a sync
    after each cast, or the pair launched before either sync."""
    def sync(h):
        return float(torch.sum(h.t))

    sync(cast(scene, rays))                 # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        sync(cast(scene, rays))
        sync(cast(scene, translate_rays(rays, off)))
    serial = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        a = cast(scene, rays)
        b = cast(scene, translate_rays(rays, off))
        sync(a)
        sync(b)
    return serial, time.perf_counter() - t0


def main(argv=None):
    p = argparse.ArgumentParser(
        description="headless ray-casting service (optixRaycasting)")
    p.add_argument("--model", "-m", default=None,
                   help=".gltf/.glb/.obj/.ply model")
    p.add_argument("--file", default="raycast.png")
    p.add_argument("--dim", default="512x512")
    p.add_argument("--measure-overlap", action="store_true",
                   help="time serialized against in-flight launches (the "
                        "two-CUDA-streams analogue)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    w, h = parse_dim(args.dim)
    scene, lo, hi = build(args.model, torch.device(args.device))
    img, rays, off = render(scene, lo, hi, w, h)
    img = img.cpu().numpy()
    save_image(args.file, (np.clip(img[::-1], 0, 1) * 255).astype(np.uint8))
    print(f"wrote {args.file} ({2 * w}x{h}, two ray sets)")
    if args.measure_overlap:
        serial, overlapped = measure_overlap(scene, rays, off)
        print(f"serialized: {serial * 1e3:.1f} ms   in flight: "
              f"{overlapped * 1e3:.1f} ms   overlap gain: "
              f"{serial / overlapped:.2f}x")


if __name__ == "__main__":
    main()
