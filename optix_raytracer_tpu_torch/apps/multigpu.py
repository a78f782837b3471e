"""optixMultiGPU: the Cornell box rendered in row and sample tiles over
ranks (counterpart of `apps/multigpu.py`).

    python -m optix_raytracer_tpu_torch.apps.multigpu --dim 512x512 \\
        --samples 8 --rows 2 --sample-shards 2

Started alone, the app launches rows x sample-shards ranks on this machine
(`multichip.distributed.launch_local`; by default one rank per visible
card, as the reference used every device): NCCL with a card each, gloo
where ranks share a card or run on the CPU. Each rank renders its band of
rows for its share of the samples (`multichip/tiles.py`), the frame is
gathered, and rank 0 writes it. `--tint` colours each band as the
reference's deviceColor() shows tile ownership (`optixMultiGPU.cu:303`).
`--multihost` brings the process group up from the environment instead
(torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK and
LOCAL_WORLD_SIZE, or the SLURM / OMPI names) and renders over the
(slice, rows, samples) mesh with one slice per host
(`multichip/multislice.py`).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core import film as film_mod
from ..io.image import save_image
from ..multichip import distributed, multislice, tiles
from ..scene.builtins import cornell_box, cornell_camera
from ._cli import parse_dim

TINTS = np.array([[1, .7, .7], [.7, 1, .7], [.7, .7, 1], [1, 1, .6],
                  [1, .6, 1], [.6, 1, 1], [1, .8, .6], [.8, .6, 1]],
                 np.float32)


def render_rank(info, width, height, samples, n_rows, n_samples, tint,
                max_depth):
    """One rank's part (multigpu.py:27-50) → on rank 0 (accum [H, W, 3]
    numpy, subframe, rays of all ranks), None elsewhere."""
    mesh = tiles.make_mesh(n_rows=n_rows, n_samples=n_samples)
    if samples % n_samples:
        raise ValueError(f"{samples} samples do not split into {n_samples} "
                         f"sample shards")
    scene = cornell_box(mesh.device)
    cam = cornell_camera(width, height).params(mesh.device)
    film = tiles.shard_film(film_mod.Film.create(height, width, mesh.device),
                            mesh)
    film, rays = tiles.render_accumulate_sharded(
        scene, cam, film, mesh, width, height,
        samples_per_launch=samples // n_samples, max_depth=max_depth)
    full = tiles.gather_film(film, mesh)
    if info.process_id != 0:
        return None
    accum = full.accum.cpu().numpy()
    if tint:
        tile_h = height // n_rows
        for r in range(n_rows):
            accum[r * tile_h:(r + 1) * tile_h] *= TINTS[r % len(TINTS)]
    return accum, int(full.subframe), int(rays)


def default_rows(n_samples, device) -> int:
    """Rows so that the ranks are one per visible card (one on the CPU)."""
    cards = (torch.cuda.device_count() if torch.device(device).type == "cuda"
             else 1)
    return max(cards // n_samples, 1)


def render(width=512, height=512, samples=8, n_rows=None, n_samples=1,
           tint=False, max_depth=3, device="cuda"):
    """Launch n_rows x n_samples local ranks (n_rows by `default_rows` when
    None) → rank 0's (accum, subframe, rays)."""
    if n_rows is None:
        n_rows = default_rows(n_samples, device)
    return distributed.launch_local(
        render_rank, n_rows * n_samples, width, height, samples, n_rows,
        n_samples, tint, max_depth, device=device)[0]


def render_multihost(width, height, samples, sample_shards=1, max_depth=3,
                     device="cuda"):
    """The multi-host path (multigpu.py:53-70), run by every rank a launcher
    started: bring-up from the environment, one slice per host, the frame
    gathered once → (accum numpy on rank 0 else None, subframe, rays,
    ProcessInfo)."""
    info = distributed.initialize(device=device)
    mesh = distributed.pod_mesh(samples_per_slice=sample_shards,
                                device=device)
    if samples % sample_shards:
        raise ValueError(f"{samples} samples do not split into "
                         f"{sample_shards} sample shards")
    scene = cornell_box(mesh.device)
    cam = cornell_camera(width, height).params(mesh.device)
    film = multislice.shard_film(
        film_mod.Film.create(height, width, mesh.device), mesh)
    film, rays = multislice.render_accumulate_multislice(
        scene, cam, film, mesh, width, height,
        samples_per_launch=samples // sample_shards, max_depth=max_depth)
    full = tiles.gather_film(film, mesh)
    rays = multislice.total_rays(rays, mesh)
    accum = full.accum.cpu().numpy() if info.process_id == 0 else None
    return accum, int(full.subframe), int(rays), info


def main(argv=None):
    p = argparse.ArgumentParser(description="multi-GPU tiles (optixMultiGPU)")
    p.add_argument("--file", default="multigpu.png")
    p.add_argument("--dim", default="512x512")
    p.add_argument("--samples", type=int, default=8)
    p.add_argument("--rows", type=int, default=None)
    p.add_argument("--sample-shards", type=int, default=1)
    p.add_argument("--tint", action="store_true")
    p.add_argument("--multihost", action="store_true",
                   help="bring up from the launcher's environment (torchrun:"
                        " MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK) and "
                        "render over (slice, rows, samples) with one slice "
                        "per host; alone it is one rank")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    w, h = parse_dim(args.dim)
    if args.multihost:
        accum, spp, rays, info = render_multihost(
            w, h, args.samples, sample_shards=args.sample_shards,
            device=args.device)
        if info.process_id == 0:
            save_image(args.file, film_mod.make_color(
                torch.as_tensor(accum)).numpy())
            print(f"wrote {args.file} ({info.num_processes} ranks, "
                  f"{spp} spp, {rays} rays)")
        distributed.shutdown()
        return
    rows = args.rows or default_rows(args.sample_shards, args.device)
    accum, spp, rays = render(w, h, samples=args.samples, n_rows=rows,
                              n_samples=args.sample_shards, tint=args.tint,
                              device=args.device)
    save_image(args.file, film_mod.make_color(torch.as_tensor(accum)).numpy())
    print(f"wrote {args.file} ({rows * args.sample_shards} ranks, {spp} spp,"
          f" {rays} rays)")


if __name__ == "__main__":
    main()
