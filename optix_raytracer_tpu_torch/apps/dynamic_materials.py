"""Run-time material swaps through SBT updates (counterpart of
`apps/dynamic_materials.py`, the `optixDynamicMaterials` sample,
`optixDynamicMaterials.cpp:122, 310, 475-488`): rewriting a hit-group
record is a new material table (`swap_material_color`), repointing a
geometry range at another record a new per-triangle material column
(`swap_sbt_offset`); the next launch uses it, with no rebuild.

    python -m optix_raytracer_tpu_torch.apps.dynamic_materials --file dm.ppm

The Cornell box renders through `render_accumulate` with impl "auto": the
fused path-trace kernel (kernel 3) on a CUDA device, its plain version on
the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..core import film as film_mod
from ..io.image import save_image
from ..scene.builtins import cornell_box, cornell_camera
from ..scene.device_scene import DeviceScene
from ..wavefront.engine import render_accumulate
from ._cli import parse_dim


def swap_material_color(scene: DeviceScene, mat_id: int,
                        new_color) -> DeviceScene:
    """The `updateHitGroupRecord` role: the scene with material `mat_id`'s
    base colour replaced."""
    table = scene.materials
    base = table.base_color.clone()
    base[mat_id] = torch.as_tensor(new_color, dtype=torch.float32,
                                   device=base.device)
    return dataclasses.replace(
        scene, materials=dataclasses.replace(table, base_color=base))


def swap_sbt_offset(scene: DeviceScene, tri_range, new_mat: int
                    ) -> DeviceScene:
    """The sbt-offset rewrite (`optixDynamicMaterials.cpp:310`): the
    triangles [lo, hi) repointed at material `new_mat`. A scene with a
    cluster table bakes its material ids into it, so only a scene without
    one is repointed this way."""
    if scene.has_clusters or scene.instance_clusters:
        raise ValueError("swap_sbt_offset: the scene's cluster tables hold "
                         "their material ids; rebuild the scene instead")
    lo, hi = tri_range
    tri_mat = scene.tri_mat.clone()
    tri_mat[lo:hi] = new_mat
    return dataclasses.replace(scene, tri_mat=tri_mat)


def scene_for_phase(phase: int, device) -> DeviceScene:
    """The Cornell box after `phase` swaps: 1 recolours the white record
    gold, 2 also repoints the tall block (triangles 20-29) at the red
    record."""
    scene = cornell_box(device)
    if phase >= 1:
        scene = swap_material_color(scene, 0, (0.9, 0.7, 0.2))
    if phase >= 2:
        scene = swap_sbt_offset(scene, (20, 30), 2)
    return scene


def render(width=512, height=512, samples=8, phase=0, device="cuda"):
    """→ (linear radiance [H, W, 3] on `device`, rays_traced)."""
    scene = scene_for_phase(phase, device)
    cam = cornell_camera(width, height).params(device)
    film = film_mod.Film.create(height, width, device)
    film, rays = render_accumulate(scene, cam, film, width, height,
                                   samples_per_launch=samples, max_depth=3,
                                   chunk_size=None)
    return film.accum, rays


def main(argv=None):
    p = argparse.ArgumentParser(
        description="run-time material swaps (optixDynamicMaterials)")
    p.add_argument("--file", default="dynmat.png")
    p.add_argument("--dim", default="512x512")
    p.add_argument("--phase", type=int, default=2,
                   help="0: original, 1: recolored record, 2: +sbt-offset "
                        "swap")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    w, h = parse_dim(args.dim)
    t0 = time.perf_counter()
    accum, _ = render(w, h, phase=args.phase, device=torch.device(args.device))
    img = film_mod.make_color(accum).cpu().numpy()
    dt = time.perf_counter() - t0
    save_image(args.file, img)
    print(f"wrote {args.file} (phase {args.phase}, {dt:.3f}s, on "
          f"{args.device})")


if __name__ == "__main__":
    main()
