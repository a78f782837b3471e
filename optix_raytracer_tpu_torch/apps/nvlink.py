"""optixNVLink: texture placement over ranks (counterpart of `apps/nvlink.py`).

    python -m optix_raytracer_tpu_torch.apps.nvlink --ranks 4 \\
        --budget-mb 0.5 --check

The app launches `--ranks` local ranks (default: one per visible card;
NCCL with a card each, gloo where ranks share one), builds a textured scene
(the bench's four-map PBR floor and panel), places its texture stacks by
the policy of `multichip/memory.py` (replicate / one copy per island /
global sharding, from the stacks' size against the per-rank budget),
reports the plan and the bytes each rank keeps at rest, and renders through
the placed stacks: each launch gathers them inside the island and drops
them after (the reference's P2P sampler, `optixNVLink.cpp:1524-1569`).
With `--check` it also renders from the whole stacks and requires the two
images to be equal bit for bit. Rank 0 writes the image.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core import film as film_mod
from ..core.camera import Camera
from ..io.image import save_image
from ..multichip import distributed, memory, tiles
from ..scene.device_scene import make_device_scene
from ..shade import materials as mat
from ..shade.lights import ParallelogramLight
from ..wavefront.engine import render_accumulate
from ._cli import parse_dim


def textured_scene(tex_px=256, seed=0, device="cuda"):
    """Floor and panel with base, normal, metallic-roughness and emissive
    maps (nvlink.py:37-72); `tex_px` pushes the stacks across the policy's
    thresholds."""
    rng = np.random.default_rng(seed)
    tex_base = rng.uniform(0.1, 0.9, (tex_px, tex_px, 3)).astype(np.float32)
    nm = rng.normal(0, 0.2, (tex_px // 2, tex_px // 2, 3)).astype(np.float32)
    nm[..., 2] = 1.0
    nm /= np.linalg.norm(nm, axis=-1, keepdims=True)
    tex_norm = (nm * 0.5 + 0.5).astype(np.float32)
    tex_mr = rng.uniform(0, 1, (tex_px // 2, tex_px // 2, 3)).astype(
        np.float32)
    tex_em = rng.uniform(0, 0.2, (tex_px // 4, tex_px // 4, 3)).astype(
        np.float32)
    s = 3.0
    verts = np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s],
                      [-1.0, 0.0, -0.5], [1.0, 0.0, -0.5],
                      [1.0, 1.6, -0.5], [-1.0, 1.6, -0.5]], np.float32)
    idx = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7]], np.int32)
    uvs = np.array([[0, 0], [4, 0], [4, 4], [0, 4],
                    [0, 0], [2, 0], [2, 2], [0, 2]], np.float32)
    mats = [{"kind": mat.PBR, "base_color": (1, 1, 1), "base_tex": 0,
             "normal_tex": 1, "mr_tex": 2, "emissive_tex": 3,
             "emission": (1.0, 1.0, 1.0), "metallic": 1.0,
             "roughness": 1.0}]
    light = ParallelogramLight.make((-1.0, 3.0, -1.0), (2, 0, 0),
                                    (0, 0, 2), (8.0, 8.0, 8.0), device)
    return make_device_scene(verts, idx, np.zeros(4, np.int32), mats, device,
                             uvs=uvs,
                             textures=[tex_base, tex_norm, tex_mr, tex_em],
                             area_light=light)


def render(scene, width, height, samples, max_depth=3):
    """One launch of `samples` samples (nvlink.py:75-82) → uint8 RGBA
    [H, W, 4] numpy."""
    dev = scene.device
    cam = Camera(eye=(0, 1.5, -4.5), lookat=(0, 0.6, 0), up=(0, 1, 0),
                 fov_y=40.0, aspect=width / height).params(dev)
    film, _ = render_accumulate(scene, cam, film_mod.Film.create(
        height, width, dev), width, height, samples_per_launch=samples,
                                max_depth=max_depth, chunk_size=None)
    return film_mod.make_color(film.accum).cpu().numpy()


def run_rank(info, width, height, samples, tex_size, budget, check):
    """One rank (nvlink.py:85-128): place, report, render through the
    placed stacks, and with `check` against the whole stacks → the report
    with `per_chip_bytes_measured`, `replicated_bytes` and
    `bit_equal` (None without `check`), and on rank 0 the image."""
    mesh = tiles.make_mesh(n_samples=1)
    scene = textured_scene(tex_px=tex_size, device=mesh.device)
    replicated = memory.per_chip_texture_bytes(scene)
    ref = render(scene, width, height, samples) if check else None
    placed, report = memory.place_scene_textures(scene, mesh,
                                                 budget_bytes=budget)
    del scene       # at rest the rank keeps its shard only
    report.update(per_chip_bytes_measured=memory.per_chip_texture_bytes(
        placed), replicated_bytes=replicated, ranks=mesh.size)
    with placed.gathered() as full:
        img = render(full, width, height, samples)
    report["bit_equal"] = (None if ref is None
                           else bool(np.array_equal(img, ref)))
    if info.process_id == 0:
        report["image"] = img
    return report


def main(argv=None):
    p = argparse.ArgumentParser(
        description="texture placement over ranks (optixNVLink)")
    p.add_argument("--file", default="nvlink.png")
    p.add_argument("--dim", default="256x256")
    p.add_argument("--samples", type=int, default=4)
    p.add_argument("--tex-size", type=int, default=256,
                   help="base texture resolution (raise it to cross the "
                        "placement thresholds)")
    p.add_argument("--budget-mb", type=float, default=None,
                   help="per-rank texture budget in MB (default: the "
                        "policy's 256 MB; small values force sharding, the "
                        "reference's --peers nvlink)")
    p.add_argument("--ranks", type=int, default=None,
                   help="ranks to launch (default: one per visible card)")
    p.add_argument("--check", action="store_true",
                   help="also render from the whole stacks and require "
                        "bit-equal images")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    w, h = parse_dim(args.dim)
    budget = (int(args.budget_mb * (1 << 20)) if args.budget_mb is not None
              else memory.DEFAULT_TEXTURE_BUDGET)
    n = args.ranks or max(torch.cuda.device_count()
                          if torch.device(args.device).type == "cuda" else 1,
                          1)
    reports = distributed.launch_local(run_rank, n, w, h, args.samples,
                                       args.tex_size, budget, args.check,
                                       device=args.device)
    report(reports, budget)
    if args.check:
        if not all(r["bit_equal"] for r in reports):
            raise SystemExit("placed render != replicated render")
        print("placed render matches replicated render bit-exactly")
    save_image(args.file, reports[0]["image"])
    print(f"wrote {args.file} ({w}x{h}, {args.samples} spp)")
    return reports


def report(reports, budget):
    """The plan and the bytes at rest, as the reference prints them."""
    r = reports[0]
    nbytes, per = r["total_bytes"], max(r["per_chip_bytes_measured"] for r
                                        in reports)
    print(f"ranks: {r['ranks']} | texture stacks: {nbytes / 1e6:.2f} MB | "
          f"budget/rank: {budget / 1e6:.2f} MB")
    if r["mode"] == "replicate":
        print(f"plan: replicate on all {r['replicas']} ranks "
              f"({per / 1e6:.2f} MB/rank)")
    else:
        print(f"plan: mode={r['mode']} replicas={r['replicas']} "
              f"island_axes={r['island_axes']} | per-rank "
              f"{per / 1e6:.2f} MB ({nbytes / max(per, 1):.1f}x saving vs "
              f"replicate)")


if __name__ == "__main__":
    main()
