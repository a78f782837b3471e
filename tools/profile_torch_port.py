"""Where the time of one headline launch goes in the PyTorch/CUDA port.

--scene cornell (the default) profiles one Cornell launch (default
1920x1088, 16 samples per launch, depth 4) through the fused kernel
(impl="fused") and through the lock-step wavefront (impl="wavefront");
--scene knot profiles one launch of the 25,202-triangle knot scene
(knot_scene(200, 63); default depth 3) through the sample-major path
(impl="spl") and the sequential, coherence-sorted path (impl="wavefront"),
both over the cluster kernels; --scene knot4m the same for the
4,002,002-triangle knot (knot_scene(1450, 1380), the supercluster tier). torch.profiler prints for each: the wall time
of the launch, the device time summed over kernels, the device's idle share
of the window, and the kernels that take the most device time. Needs a CUDA
device; with --out DIR it also writes the Chrome traces there.

    python tools/profile_torch_port.py [--scene cornell|knot|knot4m]
        [--dim 1920x1088] [--spl 16] [--depth N] [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _busy_us(events):
    """Union of the device intervals of the kernels, in microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def profile(tag, impl, scene, cam, w, h, spl, depth, out_dir):
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from optix_raytracer_tpu_torch.core.film import Film
    from optix_raytracer_tpu_torch.wavefront.engine import render_accumulate

    dev = scene.device
    render_accumulate(scene, cam, Film.create(h, w, dev), w, h, spl, depth,
                      impl=impl)                               # warm-up
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, rays = render_accumulate(scene, cam, Film.create(h, w, dev), w, h,
                                    spl, depth, impl=impl)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir,
                                              f"trace_{tag}_{impl}.json"))
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us(kernels)
    by_name = {}
    for e in kernels:
        d = by_name.setdefault(e.name, [0, 0.0])
        d[0] += 1
        d[1] += e.time_range.end - e.time_range.start
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return dict(scene=tag, impl=impl, wall_ms=wall * 1e3, rays=int(rays),
                device_busy_ms=busy / 1e3,
                idle_share_of_wall=1.0 - busy / 1e3 / (wall * 1e3),
                kernel_launches=len(kernels),
                top=[dict(name=n[:80], calls=c, ms=t / 1e3)
                     for n, (c, t) in top])


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--scene", choices=("cornell", "knot", "knot4m"), default="cornell")
    p.add_argument("--dim", default="1920x1088")
    p.add_argument("--spl", type=int, default=16)
    p.add_argument("--depth", type=int, default=None,
                   help="bounces (default 4 for cornell, 3 for the knots)")
    p.add_argument("--out", default=None,
                   help="directory for the Chrome traces (none by default)")
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_port: needs a CUDA device")
    from optix_raytracer_tpu_torch.scene import builtins
    w, h = (int(v) for v in args.dim.split("x"))
    dev = torch.device("cuda")
    if args.scene in ("knot", "knot4m"):
        mesh = (200, 63) if args.scene == "knot" else (1450, 1380)
        scene = builtins.knot_scene(*mesh, device=dev)
        cam = builtins.knot_camera(w, h).params(dev)
        impls, depth = ("spl", "wavefront"), args.depth or 3
    else:
        scene = builtins.cornell_box(dev)
        cam = builtins.cornell_camera(w, h).params(dev)
        impls, depth = ("fused", "wavefront"), args.depth or 4
    for impl in impls:
        print(json.dumps(profile(args.scene, impl, scene, cam, w, h,
                                 args.spl, depth, args.out)), flush=True)


if __name__ == "__main__":
    main()
