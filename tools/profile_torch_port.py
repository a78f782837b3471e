"""Where the time of one headline launch goes in the PyTorch/CUDA port.

--scene cornell (the default) profiles one Cornell launch (default
1920x1088, 16 samples per launch, depth 4) through the fused kernel
(impl="fused") and through the lock-step wavefront (impl="wavefront");
--scene knot profiles one launch of the 25,202-triangle knot scene
(knot_scene(200, 63); default depth 3) through the sample-major path
(impl="spl") and the sequential, coherence-sorted path (impl="wavefront"),
both over the cluster kernels; --scene knot4m the same for the
4,002,002-triangle knot (knot_scene(1450, 1380), the supercluster tier);
--scene prims (bench.py's whitted_prims: 2 triangles, 4 custom prims, a
glass shell), --scene pbr (bench.py's pbr_ggx: the Cornell box with
rough-metal white surfaces), --scene instanced (bench.py's
cornell_instanced_mrays scene: 22 shared triangles in 3 instances) and
--scene smooth_knot (knot_scene(16, 15): 482 smooth triangles, no cluster
table; default depth 3) and --scene textured (bench.py's textured scene: 4
triangles, base, normal, metallic-roughness and emissive maps; default 4
samples per launch, depth 3) profile one launch (default depth 4) through
the fused kernel's instantiation for that scene (impl="fused") and through
the wavefront (impl="wavefront"). torch.profiler prints for each: the wall time of the launch, the device
time summed over kernels, the device's idle share of the window, and the
kernels that take the most device time. Needs a CUDA device; with --out DIR
it also writes the Chrome traces there.

--qwalk (with a knot scene) runs the launches under ORT_QWALK=1, through
the cluster-major queue (accel/qwalk.py), and adds the queue's split of the
device time: kernel 7 and kernel 8 (by kernel name), the queue's torch ops
(packing, work-list build, marshalling, per-ray reduction), the walks that
answered overflowed queries, the walks outside the queue (bounce-0 closest
hits), and how many queries the queue answered or handed to the walk.

    python tools/profile_torch_port.py [--scene cornell|knot|knot4m|prims|pbr|
        instanced|smooth_knot|textured] [--dim 1920x1088] [--spl N]
        [--depth N] [--qwalk] [--out DIR]
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


# Kernel names of kernels 7 and 8 (csrc/clusters.cu).
_QWALK_KERNELS = {"kernel7": "cull_exact_kernel<3", "kernel8_closest":
                  "qwalk_closest_kernel", "kernel8_any": "qwalk_any_kernel"}
# The profiler ranges of --qwalk. The profiler also records each range on
# the device's timeline; those records are not kernels.
_RANGES = ("qwalk.query", "clusters.query")


def _label_queries():
    """Wrap the queue's and the cluster walks' queries in profiler ranges
    (module attributes, looked up at call time by their callers)."""
    import torch
    from optix_raytracer_tpu_torch.accel import clusters, qwalk
    for mod, name, label in ((qwalk, "closest_hit", "qwalk.query"),
                             (qwalk, "any_hit", "qwalk.query"),
                             (clusters, "closest_hit", "clusters.query"),
                             (clusters, "any_hit", "clusters.query")):
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _label=label, **k):
            with torch.profiler.record_function(_label):
                return _fn(*a, **k)
        setattr(mod, name, wrapped)


def _inside(e, label):
    """True when a host-side range named `label` encloses event e."""
    p = e.cpu_parent
    while p is not None:
        if p.name == label:
            return True
        p = p.cpu_parent
    return False


def _qwalk_split(prof, kernels, busy_ms):
    """The queue's share of the device time, in ms (see the module doc).
    Kernels 7-8 by name; the others by the ranges' records on the device's
    timeline (the launches of a range run inside its record there, as the
    launches of one stream run in order): the queue's torch ops, the walks
    of overflowed queries and the walks outside the queue. A walk's record
    is matched to its host-side range by order, and the host side says
    whether a queue query called it. `rest` is the launch's other device
    time (shading, RNG, sorts, raygen)."""
    import torch
    dev, host = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == dev and e.name in _RANGES)
    walks = sorted((e for e in prof.events() if e.device_type == host
                    and e.name == "clusters.query"),
                   key=lambda e: e.time_range.start)
    fallback = iter([_inside(e, "qwalk.query") for e in walks])
    spans = [(a, b, "overflow.walk" if n == "clusters.query"
              and next(fallback, False) else n) for a, b, n in spans]
    out = dict.fromkeys((*_QWALK_KERNELS, "queue_torch_ops",
                         "overflow_walks", "walks_outside_queue"), 0.0)
    for k in kernels:
        s, e = k.time_range.start, k.time_range.end
        inside = {n for a, b, n in spans if a <= s and e <= b}
        key = next((key for key, pat in _QWALK_KERNELS.items()
                    if pat in k.name), None)
        if key is None and "overflow.walk" in inside:
            key = "overflow_walks"
        elif key is None and "clusters.query" in inside:
            key = "walks_outside_queue"
        elif key is None and "qwalk.query" in inside:
            key = "queue_torch_ops"
        if key is not None:
            out[key] += (e - s) / 1e3
    out["rest"] = busy_ms - sum(out.values())
    out["ranges"] = {n: sum(x[2] == n for x in spans)
                     for n in (*_RANGES, "overflow.walk")}
    return out


def profile(tag, impl, scene, cam, w, h, spl, depth, out_dir, qwalk=False):
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from optix_raytracer_tpu_torch.accel import qwalk as Q
    from optix_raytracer_tpu_torch.core.film import Film
    from optix_raytracer_tpu_torch.wavefront.engine import render_accumulate

    dev = scene.device
    render_accumulate(scene, cam, Film.create(h, w, dev), w, h, spl, depth,
                      impl=impl)                               # warm-up
    torch.cuda.synchronize()
    Q.reset_stats()
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
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in _RANGES]
    busy = _busy_us(kernels)
    by_name = {}
    for e in kernels:
        d = by_name.setdefault(e.name, [0, 0.0])
        d[0] += 1
        d[1] += e.time_range.end - e.time_range.start
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    out = dict(scene=tag, impl=impl, wall_ms=wall * 1e3, rays=int(rays),
               device_busy_ms=busy / 1e3,
               idle_share_of_wall=1.0 - busy / 1e3 / (wall * 1e3),
               kernel_launches=len(kernels),
               top=[dict(name=n[:80], calls=c, ms=t / 1e3)
                    for n, (c, t) in top])
    if qwalk:
        out.update(qwalk_ms=_qwalk_split(prof, kernels, busy / 1e3),
                   qwalk_queries=dict(Q.STATS))
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--scene", choices=("cornell", "knot", "knot4m", "prims",
                                       "pbr", "instanced", "smooth_knot",
                                       "textured"),
                   default="cornell")
    p.add_argument("--dim", default="1920x1088")
    p.add_argument("--spl", type=int, default=None,
                   help="samples per launch (default 4 for the textured "
                        "scene, else 16)")
    p.add_argument("--depth", type=int, default=None,
                   help="bounces (default 3 for the knot and textured "
                        "scenes, else 4)")
    p.add_argument("--qwalk", action="store_true",
                   help="knot scenes: run through the cluster-major queue "
                        "(ORT_QWALK=1) and split its device time")
    p.add_argument("--out", default=None,
                   help="directory for the Chrome traces (none by default)")
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_port: needs a CUDA device")
    from optix_raytracer_tpu_torch.scene import builtins
    if args.qwalk:
        if args.scene not in ("knot", "knot4m"):
            raise SystemExit("profile_torch_port: --qwalk needs a knot scene")
        os.environ["ORT_QWALK"] = "1"
        _label_queries()
    w, h = (int(v) for v in args.dim.split("x"))
    dev = torch.device("cuda")
    if args.scene in ("knot", "knot4m"):
        mesh = (200, 63) if args.scene == "knot" else (1450, 1380)
        scene = builtins.knot_scene(*mesh, device=dev)
        cam = builtins.knot_camera(w, h).params(dev)
        impls, depth = ("spl", "wavefront"), args.depth or 3
    elif args.scene == "smooth_knot":
        scene = builtins.knot_scene(16, 15, device=dev)
        cam = builtins.knot_camera(w, h).params(dev)
        impls, depth = ("fused", "wavefront"), args.depth or 3
    elif args.scene == "textured":
        scene = builtins.textured_scene(dev)
        cam = builtins.textured_camera(w, h).params(dev)
        impls, depth = ("fused", "wavefront"), args.depth or 3
    else:
        scene = {"cornell": builtins.cornell_box, "pbr": builtins.pbr_cornell,
                 "prims": builtins.prims_scene,
                 "instanced": builtins.cornell_box_instanced}[args.scene](dev)
        camera = (builtins.prims_camera if args.scene == "prims"
                  else builtins.cornell_camera)
        cam = camera(w, h).params(dev)
        impls, depth = ("fused", "wavefront"), args.depth or 4
    for impl in impls:
        spl = args.spl or (4 if args.scene == "textured" else 16)
        print(json.dumps(profile(args.scene, impl, scene, cam, w, h,
                                 spl, depth, args.out, args.qwalk)),
              flush=True)


if __name__ == "__main__":
    main()
