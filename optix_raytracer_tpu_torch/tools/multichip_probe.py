"""The multichip layer's and the training tool's runs, shared by
`chip_smoke.py` (phases p1-p4, on the card) and the CPU tests.

The rank functions run under `multichip.distributed.launch_local`, one per
rank: `layouts_case` (the sharded, interleaved and multislice launches of
the Cornell box, each timed, its kernels' launches counted on the rank
alone, the frame gathered), `placement_case` (the nvlink app's rank body
and two more placements of its scene) and `checkpoint_case` (a sharded
checkpoint written by the ranks, then a straight and a resumed launch on
two of them). `training_case` renders `train_denoiser`'s dataset and
takes its Adam steps in one process, the first step held against the
CPU's from the same parameters and batch.
"""
from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from .. import kernels
from ..core import checkpoint
from ..core.film import Film
from ..multichip import memory, multislice, tiles
from ..scene.builtins import cornell_box, cornell_camera


# The denoiser's bars (atol, rtol) for the card against the CPU
# (tests/test_torch_denoise.py; TF32 off on both sides).
GRAD_BARS = (1e-4, 1e-3)


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def digest(a: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()


def _launches():
    return {k: v for k, v in kernels.LAUNCHES.items() if v}


def _frame(info, film):
    """(accum on rank 0 else None, its digest, subframe)."""
    a = film.accum.cpu().numpy()
    return (a if info.process_id == 0 else None), digest(a), int(
        film.subframe)


def _timed(mesh, fn):
    """fn() between two barriers → (result, ms of this rank's own work,
    ms until every rank is done)."""
    sync(mesh.device)
    tiles.barrier(mesh)
    t0 = time.perf_counter()
    out = fn()
    sync(mesh.device)
    t1 = time.perf_counter()
    tiles.barrier(mesh)
    return out, 1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t0)


def layouts_case(info, w, h, spl, depth, shapes):
    """One launch of each layout on the world's ranks: "sharded" (rows x
    samples = shapes["sharded"], spl / samples each, twice: the second,
    "sharded_2", continues the film), "interleaved" (shapes["interleaved"]
    rows, spl each) and "multislice" (shapes["multislice"] = (slices, rows,
    samples), spl / samples each), all of spl samples over the mesh.
    → {layout: dict(accum (rank 0), digest, subframe, rays of all ranks,
    ms, wall_ms, gather_ms, launches)} and the multislice mesh's
    collective log, split at the gather."""
    dev = info.device
    scene = cornell_box(dev)
    cam = cornell_camera(w, h).params(dev)
    out = {}

    def run(key, mesh, render, film, per_rank, gather):
        kernels.reset_launches()
        (film, rays), ms, wall = _timed(mesh, lambda: render(
            scene, cam, film, mesh, w, h, samples_per_launch=per_rank,
            max_depth=depth))
        launches = _launches()
        full, g_ms, _ = _timed(mesh, lambda: gather(film, rays))
        accum, dig, sub = _frame(info, full[0])
        out[key] = dict(accum=accum, digest=dig, subframe=sub,
                        rays=int(full[1]), ms=ms, wall_ms=wall,
                        gather_ms=g_ms, launches=launches)
        return film

    def gather(mesh):
        return lambda film, rays: (tiles.gather_film(film, mesh), rays)

    rows, samples = shapes["sharded"]
    mesh = tiles.make_mesh(rows, samples)
    film = tiles.shard_film(Film.create(h, w, dev), mesh)
    for key in ("sharded", "sharded_2"):
        film = run(key, mesh, tiles.render_accumulate_sharded, film,
                   spl // samples, gather(mesh))
    mesh = tiles.make_mesh(shapes["interleaved"], 1)
    run("interleaved", mesh, tiles.render_accumulate_interleaved,
        tiles.shard_film(Film.create(h, w, dev), mesh), spl, gather(mesh))
    n_sl, rows, samples = shapes["multislice"]
    mesh = multislice.make_multislice_mesh(n_sl, rows, samples)
    mark = []

    def gather_slices(film, rays):
        mark.append(len(mesh.log))
        return (tiles.gather_film(film, mesh),
                multislice.total_rays(rays, mesh))
    run("multislice", mesh, multislice.render_accumulate_multislice,
        multislice.shard_film(Film.create(h, w, dev), mesh), spl // samples,
        gather_slices)
    log = [entry for entry in mesh.log if entry[0] != "barrier"]
    n_render = len([e for e in mesh.log[:mark[0]] if e[0] != "barrier"])
    out["multislice_log"] = (log[:n_render], log[n_render:],
                             mesh.ranks.tolist())
    return out


def placement_case(info, w, h, samples, tex_px, budget):
    """nvlink's rank body over the world's rows (`apps/nvlink.run_rank`,
    its launches counted), then its scene at the same budget over (2
    slices, world / 2 rows) and its atlas alone over rows → each placement's
    report, bytes at rest, bit-equality to the whole stacks' render and
    the collectives it ran."""
    from ..apps import nvlink
    kernels.reset_launches()
    rep = nvlink.run_rank(info, w, h, samples, tex_px, budget, True)
    rep.update(launches=_launches())
    rep.pop("image", None)
    out = {"rows": rep}
    mesh = multislice.make_multislice_mesh(2, info.num_processes // 2, 1)
    scene = nvlink.textured_scene(tex_px=tex_px, device=info.device)
    ref = nvlink.render(scene, w, h, samples)
    for key, (placed, report) in (
            ("slices", memory.place_scene_textures(scene, mesh, budget)),
            ("atlas_rows", (memory.shard_scene_textures(scene, mesh), {}))):
        mesh.log.clear()
        with placed.gathered() as full:
            img = nvlink.render(full, w, h, samples)
        out[key] = dict(report, bit_equal=bool(np.array_equal(img, ref)),
                        per_chip_bytes_measured=(
                            memory.per_chip_texture_bytes(placed)),
                        log=list(mesh.log))
    return out


def checkpoint_case(info, w, h, spl, depth, path):
    """A sharded launch on 2 rows x 2 samples (spl / 2 each), its film saved
    by the 4 ranks; then, on ranks 0-1 as 2 rows x 1 sample, the straight
    run continues the gathered film and the resumed run its rows loaded
    from the checkpoint, one launch of spl each → on every rank the first
    frame; on ranks 0-1 also the loaded band, the config and the straight
    and resumed frames (digests; arrays on rank 0)."""
    dev = info.device
    scene = cornell_box(dev)
    cam = cornell_camera(w, h).params(dev)
    mesh = tiles.make_mesh(2, 2)
    film = tiles.shard_film(Film.create(h, w, dev), mesh)
    film, _ = tiles.render_accumulate_sharded(
        scene, cam, film, mesh, w, h, samples_per_launch=spl // 2,
        max_depth=depth)
    first = tiles.gather_film(film, mesh)
    t0 = time.perf_counter()
    checkpoint.save_checkpoint_sharded(path, film, mesh,
                                       cornell_camera(w, h), {"spl": spl})
    out = {"first": _frame(info, first),
           "save_ms": 1e3 * (time.perf_counter() - t0)}
    pair = tiles.make_mesh(2, 1, ranks=[0, 1])
    if pair.coord is None:
        return out
    t0 = time.perf_counter()
    loaded, _, config = checkpoint.load_checkpoint_sharded(path, dev,
                                                           mesh=pair)
    out.update(load_ms=1e3 * (time.perf_counter() - t0), config=config,
               loaded_band=(loaded.accum.cpu().numpy(), int(loaded.subframe)))
    for key, f in (("straight", tiles.shard_film(first, pair)),
                   ("resumed", loaded)):
        f, _ = tiles.render_accumulate_sharded(
            scene, cam, f, pair, w, h, samples_per_launch=spl,
            max_depth=depth)
        out[key] = _frame(info, tiles.gather_film(f, pair))
    return out


def rank_phases(info, cfg):
    """chip_smoke's p1-p3 on one rank: layouts_case at cfg["tiles"],
    placement_case at cfg["nvlink"], checkpoint_case at cfg["checkpoint"]
    → {"p1", "p2", "p3"}."""
    return {"p1": layouts_case(info, **cfg["tiles"]),
            "p2": placement_case(info, **cfg["nvlink"]),
            "p3": checkpoint_case(info, **cfg["checkpoint"])}


def training_case(dev, data_dir, res=256, patch=128, batch=8, steps=10,
                  clean_spp=1024, lr=1e-3, seed=0):
    """`train_denoiser`'s dataset (two scenes at `res`) and `steps` Adam
    steps at `batch` x `patch`^2 on `dev`, the first step also taken on the
    CPU from the same parameters and batch → dict(scene_ms, step_ms (mean
    of steps 2 on), losses, launches of the renders, loss_cpu, the
    gradient and parameter elements outside GRAD_BARS of the CPU's, the
    latter among those whose gradient sign the bars settle, and the count
    of those they leave open)."""
    from . import train_denoiser as td
    from ..denoise import kpcnn
    kernels.reset_launches()
    t0 = time.perf_counter()
    td.render_dataset(2, data_dir, seed=seed, clean_spp=clean_spp, res=res,
                      device=dev)
    sync(dev)
    scene_ms = 1e3 * (time.perf_counter() - t0) / 2
    launches = _launches()
    data = td.load_dataset(data_dir)
    rng = np.random.default_rng(seed)
    cpu = torch.device("cpu")
    first = td.sample_batch(data, rng, batch, patch, cpu)
    results = {}
    for where in (cpu, torch.device(dev)):
        params = kpcnn.init_params(torch.Generator().manual_seed(seed),
                                   device=where)
        opt, sched = td.make_optimizer(params, lr, steps)
        b = tuple(t.to(where) for t in first)
        loss = td.train_step(params, opt, sched, b)
        results[where.type] = (float(loss), {
            k: (p.grad.detach().cpu(), p.detach().cpu())
            for k, p in params.items()}, params, opt, sched)
    loss_cpu, ref, *_ = results["cpu"]
    loss_dev, got, params, opt, sched = results[torch.device(dev).type]
    atol, rtol = GRAD_BARS
    grad_out = param_out = open_sign = 0
    for k in ref:
        (g_ref, p_ref), (g, p) = ref[k], got[k]
        g_bar = atol + rtol * g_ref.abs()
        grad_out += int(((g - g_ref).abs() > g_bar).sum())
        # Adam's first step moves a parameter by about lr times the sign of
        # its gradient: where the gradient is within its bar of 0, the two
        # devices may step opposite ways
        p_far = (p - p_ref).abs() > atol + rtol * p_ref.abs()
        open_sign += int((p_far & (g_ref.abs() <= g_bar)).sum())
        param_out += int((p_far & (g_ref.abs() > g_bar)).sum())
    losses = [loss_dev]
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        losses.append(float(td.train_step(
            params, opt, sched, td.sample_batch(data, rng, batch, patch,
                                                dev))))
    sync(dev)
    step_ms = 1e3 * (time.perf_counter() - t0) / max(steps - 1, 1)
    return dict(scene_ms=scene_ms, step_ms=step_ms, losses=losses,
                loss_cpu=loss_cpu, launches=launches,
                grad_outside_bars=grad_out, params_outside_bars=param_out,
                open_sign_params=open_sign)
