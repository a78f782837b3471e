"""An abortable out-of-process compile beside a live render loop
(counterpart of `apps/module_create_abort.py`, the `optixModuleCreateAbort`
sample).

The sample compiles a module in a spawned child process
(`optixModuleCreateAbort.cpp:30,76`) while the parent keeps rendering with
the current pipeline, then kills the child mid-compile or hot-swaps when it
finishes (`:446, 586-599`). Here `api.AbortableCompile` runs the first call
of `heavy_entry` (a chain of 120 matrix products) in the child, on the CPU
as the reference's child compiles there; the parent renders Whitted frames
(128x128, depth 2; kernels 1-2 on CUDA) until it aborts the first compile,
then runs a second one to completion and writes the last frame.

    python -m optix_raytracer_tpu_torch.apps.module_create_abort
"""
from __future__ import annotations

import argparse
import time

import torch

from ..api.module import AbortableCompile
from ..core import film
from ..io.image import save_image
from ..scene.builtins import whitted_camera, whitted_scene
from ..wavefront.whitted import render_whitted_sample
from ._cli import parse_dim

_ENTRY_SHAPES = [((256, 256), "float32")]
_ME = "optix_raytracer_tpu_torch.apps.module_create_abort"


def heavy_entry(x):
    """The module compiled out of process: a long chain of products (the
    reference compiles a full path-tracer module)."""
    for i in range(120):
        x = torch.tanh(x @ x.T * (1.0 / (i + 2.0)))
    return x


def render_frame(scene, cam, w, h, subframe):
    radiance, _ = render_whitted_sample(scene, cam, w, h, subframe,
                                        max_depth=2)
    return film.make_color(radiance).cpu().numpy()


def main(argv=None):
    p = argparse.ArgumentParser(
        description="abortable out-of-process compile "
                    "(optixModuleCreateAbort)")
    p.add_argument("--file", default="module_create_abort.png")
    p.add_argument("--dim", default="128x128")
    p.add_argument("--abort-after", type=float, default=0.5,
                   help="seconds before killing the first compile")
    p.add_argument("--no-abort", action="store_true",
                   help="let the first compile finish instead")
    p.add_argument("--device", default="cuda",
                   help="the render loop's device (the compile's child "
                        "runs on the CPU)")
    args = p.parse_args(argv)
    w, h = parse_dim(args.dim)
    device = torch.device(args.device)
    scene = whitted_scene(device)
    cam = whitted_camera(w, h).params(device)
    # The current pipeline is built first (the reference renders with the
    # old pipeline while the child compiles).
    render_frame(scene, cam, w, h, 0)

    compile1 = AbortableCompile(_ME, "heavy_entry", _ENTRY_SHAPES,
                                device="cpu")
    print("child compile started, rendering with the current pipeline "
          "meanwhile...")
    t0 = time.perf_counter()
    frames = 0
    while compile1.poll() is None:
        render_frame(scene, cam, w, h, frames)
        frames += 1
        if not args.no_abort and time.perf_counter() - t0 >= args.abort_after:
            compile1.abort()
            break
    status = compile1.poll()
    if args.no_abort or status is True:
        ok = compile1.wait()
        print(f"compile finished ok={ok} after {time.perf_counter() - t0:.2f}"
              f"s ({frames} frames rendered during it)")
        if not ok:
            raise SystemExit("the compile failed")
    else:
        print(f"aborted compile after {time.perf_counter() - t0:.2f}s "
              f"(killed mid-flight, status={status}; {frames} frames "
              f"rendered during it)")
        # the second compile runs to completion: the hot-swap
        t1 = time.perf_counter()
        compile2 = AbortableCompile(_ME, "heavy_entry", _ENTRY_SHAPES,
                                    device="cpu")
        while compile2.poll() is None:
            render_frame(scene, cam, w, h, frames)
            frames += 1
        ok = compile2.wait()
        print(f"second compile finished ok={ok} in "
              f"{time.perf_counter() - t1:.2f}s; hot-swapping")
        if not ok:
            raise SystemExit("the second compile failed")
    img = render_frame(scene, cam, w, h, frames)
    save_image(args.file, img)
    print(f"wrote {args.file} ({w}x{h}, {frames + 1} frames total, on "
          f"{device})")


if __name__ == "__main__":
    main()
