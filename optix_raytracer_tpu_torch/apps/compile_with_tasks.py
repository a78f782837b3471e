"""Module compiles fanned out to a thread pool (counterpart of
`apps/compile_with_tasks.py`, the `optixCompileWithTasks` sample).

`optixModuleCreateWithTasks` splits a module's compile into tasks that a
thread pool runs (`lib/CompileWithTasks.h:53-117`), and the sample reports
the wall-clock win over compiling one after the other. Here a compile is a
first call (`api/module.py`): the jobs are the Whitted pipeline's raygen
(`render_whitted_sample`, depth 2, kernels 1-2 on CUDA) at several film
sizes, run once each on `api.compile_with_tasks`'s pool after the kernel
library is built.

    python -m optix_raytracer_tpu_torch.apps.compile_with_tasks --serial
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from ..api.module import compile_with_tasks
from ..scene.builtins import whitted_camera, whitted_scene
from ..wavefront.whitted import render_whitted_sample


def make_jobs(n_jobs, base=48, device="cuda"):
    """n_jobs Whitted raygens at distinct film sizes → [(fn, (cam,))]."""
    scene = whitted_scene(device)
    jobs = []
    for i in range(n_jobs):
        w = h = base + 16 * i
        cam = whitted_camera(w, h).params(device)

        def entry(cam, w=w, h=h):
            return render_whitted_sample(scene, cam, w, h, 0, max_depth=2)

        jobs.append((entry, (cam,)))
    return jobs


def run(n_jobs=4, workers=4, compare_serial=False, base=48, device="cuda"):
    """→ (timings {"pool_s", "compiled", "serial_s" with compare_serial},
    the compiled callables)."""
    jobs = make_jobs(n_jobs, base=base, device=device)
    results = {}
    if compare_serial:
        t0 = time.perf_counter()
        compile_with_tasks(jobs, max_workers=1)
        results["serial_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    compiled = compile_with_tasks(jobs, max_workers=workers)
    results["pool_s"] = time.perf_counter() - t0
    results["compiled"] = len(compiled)
    return results, compiled


def main(argv=None):
    p = argparse.ArgumentParser(
        description="thread-pool module compilation (optixCompileWithTasks)")
    p.add_argument("--jobs", type=int, default=4)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--serial", action="store_true",
                   help="also time the first calls one after the other")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    res, compiled = run(args.jobs, args.workers, compare_serial=args.serial,
                        device=device)
    if "serial_s" in res:
        print(f"serial: {res['serial_s']:.2f}s")
    print(f"pool({args.workers} workers): {res['pool_s']:.2f}s "
          f"for {res['compiled']} modules")
    if "serial_s" in res and res["pool_s"] > 0:
        print(f"speedup: {res['serial_s'] / res['pool_s']:.2f}x "
              f"({os.cpu_count() or 1} host cores)")
    # the callables are live: run one
    radiance, rays = compiled[0](make_jobs(1, device=device)[0][1][0])
    print(f"module 0 executes: output {tuple(radiance.shape)}, "
          f"{int(rays)} rays, on {device}")


if __name__ == "__main__":
    main()
