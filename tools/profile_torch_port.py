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
the wavefront (impl="wavefront"). --scene whitted (apps/whitted.py's scene:
a degenerate triangle, 3 custom prims, a point and an ambient light; default
768x576, depth 6) and --scene knot_rig (the meshviewer's headlight rig on
the 25,202-triangle knot; default 768x768, depth 3) profile --spl samples
of the Whitted integrator (impl="whitted", wavefront/whitted.py
render_whitted; default 16 and 8), with the device time of the query
kernels (kernels 1-2, 4-6) split out (`query_kernels_ms`). --scene
cutouts (apps/cutouts.py's Cornell box with a checker and a circle cutout;
default 768x768, 32 samples per launch, depth 4) profiles one launch of
the wavefront (impl="wavefront", which "auto" takes), and --scene
cutout_grid (the 2,402-triangle cutout grid; default 768x768, 8 samples
per launch, depth 3) one sample-major launch (impl="spl"), each with the
query kernels split out and the alpha loops' loops and steps
(`alpha_stats`: each step one closest-hit query and one host sync).
--scene denoise renders the frame of `pathtracer --denoise` (default
1920x1088, two launches of 16 samples, depth 4) and its guide layers, then
profiles one call of each model kind chip_smoke.py's n2 times (the HDR net
and filter, the trained temporal net, UPSCALE2X, AOV, tiled, and the
optical flow; tools/denoise_probe.py).
--scene motion (`simple_motion_blur --engine`, its standalone renderer and
`motion_geometry`), --scene hair (`curves` as capsules and as swept spans,
`ribbons` and `hair` as swept cubic spans) and --scene volume
(`volume_viewer` standalone and `--engine`) profile each app's default run
(tools/mcv_probe.py: 512x512 and the app's samples), after a one-sample
warm-up, with its ms a sample, torch kernels a sample, and the query
kernels (1-2) split out.
--scene api profiles one validation-mode Pipeline.launch of each of
chip_smoke.py's a1 cases (the Cornell headline, the Whitted scene, the 25k
knot; optix_raytracer_tpu_torch/tools/api_probe.py) and of its a2 knot past
the cluster cap (4,260,002 triangles, 1920x1088, one sample, depth 3: the
BVH walk kernel), each after a warm-up launch, with the walk kernel's
device time split out (`walk_kernels_ms`).
torch.profiler prints for each: the wall time of the launch, the device
time summed over kernels, the device's idle share of the window, and the
kernels that take the most device time. Needs a CUDA device; with --out DIR
it also writes the Chrome traces there.

On a knot scene each launch also gets the split of the cluster table's
query stages outside the walks (`cull_stages_ms`): the device time of the
kernels launched inside clusters._pack_rays, _block_cull (the interval
cull), _cull_tables and _compact (the sort), and of kernel 4 by name.

--qwalk (with a knot scene) runs the launches under ORT_QWALK=1, through
the cluster-major queue (accel/qwalk.py), and adds the queue's split of the
device time: kernel 7 and kernel 8 (by kernel name), the queue's torch ops
(packing, work-list build, marshalling, per-ray reduction), the walks that
answered overflowed queries, the walks outside the queue (bounce-0 closest
hits), and how many queries the queue answered or handed to the walk.

    python tools/profile_torch_port.py [--scene cornell|knot|knot4m|prims|pbr|
        instanced|smooth_knot|textured|whitted|knot_rig|cutouts|
        cutout_grid|denoise|motion|hair|volume|api] [--dim 1920x1088]
        [--spl N] [--depth N] [--qwalk] [--out DIR]
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
                  "qwalk_kernel<true>", "kernel8_any": "qwalk_kernel<false>"}
# The profiler ranges of --qwalk. The profiler also records each range on
# the device's timeline; those records are not kernels.
_RANGES = ("qwalk.query", "clusters.query")
# The cluster table's query stages of a knot launch: profiler ranges around
# these functions of accel/clusters.py (cull_stages_ms).
_STAGES = ("_pack_rays", "_block_cull", "_cull_tables", "_compact")
_STAGE_RANGES = tuple(f"clusters.{n}" for n in _STAGES)
# Kernel names of the query kernels the Whitted path runs: kernels 1-2
# (csrc/bf.cu) and 4-6 (csrc/clusters.cu).
_QUERY_KERNELS = ("bf_kernel", "cull_exact_kernel", "cluster_walk_kernel")


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


def _label_cull_stages():
    """Wrap the cluster stages of _STAGES in profiler ranges (module
    attributes, looked up at call time by their callers)."""
    import torch
    from optix_raytracer_tpu_torch.accel import clusters
    for name in _STAGES:
        fn = getattr(clusters, name)

        def wrapped(*a, _fn=fn, _label=f"clusters.{name}", **k):
            with torch.profiler.record_function(_label):
                return _fn(*a, **k)
        setattr(clusters, name, wrapped)


def _stage_split(prof, kernels):
    """Device time (ms) of the kernels inside each range of _STAGE_RANGES
    on the device's timeline, and of kernel 4 by name."""
    import torch
    dev = torch.autograd.DeviceType.CUDA
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events()
             if e.device_type == dev and e.name in _STAGE_RANGES]
    out = {n: 0.0 for n in (*_STAGES, "kernel4")}
    for k in kernels:
        s, e = k.time_range.start, k.time_range.end
        if "cull_exact_kernel<5" in k.name:
            out["kernel4"] += (e - s) / 1e3
            continue
        for a, b, n in spans:
            if a <= s and e <= b:
                out[n.split(".", 1)[1]] += (e - s) / 1e3
                break
    return out


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


def _summary(prof, wall):
    """The device's kernels in a profile of `wall` seconds → (the kernel
    events, dict(wall_ms, device_busy_ms, idle_share_of_wall,
    kernel_launches, top: the 12 kernels of most device time))."""
    import torch
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in _RANGES + _STAGE_RANGES]
    busy = _busy_us(kernels)
    by_name = {}
    for e in kernels:
        d = by_name.setdefault(e.name, [0, 0.0])
        d[0] += 1
        d[1] += e.time_range.end - e.time_range.start
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return kernels, dict(wall_ms=wall * 1e3, device_busy_ms=busy / 1e3,
                         idle_share_of_wall=1.0 - busy / 1e3 / (wall * 1e3),
                         kernel_launches=len(kernels),
                         top=[dict(name=n[:80], calls=c, ms=t / 1e3)
                              for n, (c, t) in top])


def profile_denoise(w, h, out_dir):
    """--scene denoise: the frame `pathtracer --denoise` renders (the
    Cornell box, two launches of 16 samples, depth 4) and its guide
    layers, then one profiled call of each model kind of chip_smoke.py's
    n2 (tools/denoise_probe.py kind_calls) after a warm-up → one record
    per kind."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from optix_raytracer_tpu_torch.apps import pathtracer
    from optix_raytracer_tpu_torch.scene.builtins import (cornell_box,
                                                         cornell_camera)
    from optix_raytracer_tpu_torch.tools import denoise_probe as DP
    from optix_raytracer_tpu_torch.wavefront.engine import render_aovs

    dev = torch.device("cuda")
    cfg = DP.DENOISE
    scene, camera = cornell_box(dev), cornell_camera(w, h)
    accum, _, _ = pathtracer.render(w, h, samples=cfg["samples"],
                                    max_depth=cfg["depth"], scene=scene,
                                    camera=camera,
                                    samples_per_launch=cfg["spl"],
                                    device=dev)
    aovs = render_aovs(scene, camera.params(dev), w, h)
    for name, fn in DP.kind_calls(DP.headline_inputs(accum, aovs),
                                  dev).items():
        fn()                                                 # warm-up
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                out_dir, f"trace_denoise_{name}.json"))
        _, out = _summary(prof, wall)
        yield dict(scene="denoise", kind=name, dim=f"{w}x{h}", **out)


def mcv_runs(scene):
    """--scene motion / hair / volume: {app: (samples, run(samples))}, each
    run an app's default render on the card (tools/mcv_probe.py)."""
    import torch
    from optix_raytracer_tpu_torch.apps import (curves, hair,
                                                motion_geometry, ribbons,
                                                simple_motion_blur,
                                                volume_viewer)
    from optix_raytracer_tpu_torch.tools import mcv_probe as MP
    dev = torch.device("cuda")
    if scene == "motion":
        c, g = MP.MOTION_BLUR, MP.MOTION_GEOMETRY
        w, h = c["width"], c["height"]
        return {
            "simple_motion_blur --engine": (c["spl"], lambda n: (
                simple_motion_blur.render_engine(w, h, n, c["depth"],
                                                 device=dev))),
            "simple_motion_blur": (c["spl"], lambda n: (
                simple_motion_blur.render(w, h, samples=n, device=dev))),
            "motion_geometry": (g["spl"], lambda n: motion_geometry.render(
                g["width"], g["height"], samples=n, device=dev))}
    if scene == "hair":
        c, r, hc = MP.CURVES, MP.RIBBONS, MP.HAIR
        cs = curves.make_curve_scene(dev, c["kind"])
        css = curves.make_curve_scene(dev, c["kind"], swept=True)
        rs = ribbons.make_ribbon_scene(dev)
        return {
            "curves": (c["spl"], lambda n: curves.render(
                c["width"], c["height"], samples=n, scene=cs)),
            "curves --swept": (c["spl"], lambda n: curves.render(
                c["width"], c["height"], samples=n, scene=css)),
            "ribbons": (r["spl"], lambda n: ribbons.render(
                r["width"], r["height"], samples=n, scene=rs)),
            "hair --swept": (hc["spl"], lambda n: hair.render(
                hc["width"], hc["height"], samples=n, spline=hc["spline"],
                swept=hc["swept"], device=dev))}
    v, e = MP.VOLUME, MP.VOLUME_ENGINE
    return {
        "volume_viewer": (v["spl"], lambda n: volume_viewer.render(
            v["width"], v["height"], samples=n, res=v["res"],
            num_steps=v["steps"], device=dev)),
        "volume_viewer --engine": (e["spl"], lambda n: (
            volume_viewer.render_engine(e["width"], e["height"], n,
                                        res=e["res"], max_depth=e["depth"],
                                        device=dev)))}


def profile_mcv(scene, out_dir):
    """Each app of mcv_runs(scene): a one-sample warm-up, then its default
    run profiled → one record per app."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    for app, (spl, run) in mcv_runs(scene).items():
        run(1)                                                 # warm-up
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(spl)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                out_dir, f"trace_{scene}_{app.split()[0]}.json"))
        kernels, out = _summary(prof, wall)
        yield dict(scene=scene, app=app, spl=spl,
                   ms_per_sample=out["wall_ms"] / spl,
                   kernels_per_sample=out["kernel_launches"] / spl,
                   query_kernels_ms={
                       k: sum(e.time_range.end - e.time_range.start
                              for e in kernels if k in e.name) / 1e3
                       for k in _QUERY_KERNELS[:1]},
                   **out)


def profile_api(out_dir):
    """--scene api: a warm-up launch, then one profiled launch of each
    pipeline → one record each."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from optix_raytracer_tpu_torch import api
    from optix_raytracer_tpu_torch.scene import builtins as B
    from optix_raytracer_tpu_torch.shade.lights import ParallelogramLight
    from optix_raytracer_tpu_torch.tools import api_probe as AP
    dev = torch.device("cuda", 0)
    cases = AP.api_cases(dev)
    c = AP.PAST_CAP
    verts, idx, _, tri_mat, light = B.knot_mesh(c["segments"], c["sides"])
    groups, sbt = AP._records(B.KNOT_MATERIALS)
    cases["knot_past_cap"] = dict(
        integrator="pathtrace", groups=groups, sbt=sbt,
        handle=api.build_gas(verts, idx, device=dev), tri_mat=tri_mat,
        lights=(), area_light=ParallelogramLight.make(
            *light, (10.0, 10.0, 10.0), dev),
        camera=B.knot_camera, width=c["width"], height=c["height"], spl=1,
        depth=c["depth"])
    for name, case in cases.items():
        pipe = api.Pipeline(
            context=api.DeviceContext(validation_mode=True, device=dev),
            program_groups=case["groups"], integrator=case["integrator"],
            max_trace_depth=case["depth"], samples_per_launch=case["spl"])
        cam = case["camera"](case["width"], case["height"]).params(dev)
        AP._launch(pipe, case, cam)                            # warm-up
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            AP._launch(pipe, case, cam)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(out_dir,
                                                  f"trace_api_{name}.json"))
        kernels, out = _summary(prof, wall)
        yield dict(scene="api", pipeline=name,
                   dim=f"{case['width']}x{case['height']}", spl=case["spl"],
                   depth=case["depth"], walk_kernels_ms=sum(
                       e.time_range.end - e.time_range.start
                       for e in kernels if "bvh_walk_kernel" in e.name) / 1e3,
                   **out)


def profile(tag, impl, scene, cam, w, h, spl, depth, out_dir, qwalk=False):
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from optix_raytracer_tpu_torch.accel import qwalk as Q
    from optix_raytracer_tpu_torch.core.film import Film
    from optix_raytracer_tpu_torch.wavefront.engine import render_accumulate
    from optix_raytracer_tpu_torch.wavefront import intersect
    from optix_raytracer_tpu_torch.wavefront.whitted import render_whitted

    dev = scene.device

    def launch():
        if impl == "whitted":
            return render_whitted(scene, cam, w, h, spl, depth)[1]
        return render_accumulate(scene, cam, Film.create(h, w, dev), w, h,
                                 spl, depth, impl=impl)[1]

    launch()                                                   # warm-up
    torch.cuda.synchronize()
    Q.reset_stats()
    intersect.reset_alpha_stats()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rays = launch()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir,
                                              f"trace_{tag}_{impl}.json"))
    kernels, out = _summary(prof, wall)
    out = dict(scene=tag, impl=impl, rays=int(rays), **out)
    if tag in ("knot", "knot4m"):
        out["cull_stages_ms"] = _stage_split(prof, kernels)
    if scene.has_cutouts:
        out["alpha_stats"] = dict(intersect.ALPHA_STATS)
    if impl == "whitted" or scene.has_cutouts:
        out["query_kernels_ms"] = {
            k: sum(e.time_range.end - e.time_range.start for e in kernels
                   if k in e.name) / 1e3 for k in _QUERY_KERNELS}
    if qwalk:
        out.update(qwalk_ms=_qwalk_split(prof, kernels,
                                         out["device_busy_ms"]),
                   qwalk_queries=dict(Q.STATS))
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--scene", choices=("cornell", "knot", "knot4m", "prims",
                                       "pbr", "instanced", "smooth_knot",
                                       "textured", "whitted", "knot_rig",
                                       "cutouts", "cutout_grid",
                                       "denoise", "motion", "hair",
                                       "volume", "api"),
                   default="cornell")
    p.add_argument("--dim", default=None,
                   help="frame (default 768x576 for whitted, 768x768 for "
                        "knot_rig and the cutout scenes, else 1920x1088)")
    p.add_argument("--spl", type=int, default=None,
                   help="samples per launch (default 4 for the textured "
                        "scene, 8 for knot_rig and cutout_grid, 32 for "
                        "cutouts, else 16)")
    p.add_argument("--depth", type=int, default=None,
                   help="bounces (default 3 for the knot, knot_rig and "
                        "textured scenes, 6 for whitted, else 4)")
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
    if args.scene == "denoise":
        w, h = (int(v) for v in (args.dim or "1920x1088").split("x"))
        for rec in profile_denoise(w, h, args.out):
            print(json.dumps(rec), flush=True)
        return
    if args.scene in ("motion", "hair", "volume"):
        for rec in profile_mcv(args.scene, args.out):
            print(json.dumps(rec), flush=True)
        return
    if args.scene == "api":
        for rec in profile_api(args.out):
            print(json.dumps(rec), flush=True)
        return
    if args.qwalk:
        if args.scene not in ("knot", "knot4m"):
            raise SystemExit("profile_torch_port: --qwalk needs a knot scene")
        os.environ["ORT_QWALK"] = "1"
        _label_queries()
    dim = args.dim or {"whitted": "768x576", "knot_rig": "768x768",
                       "cutouts": "768x768",
                       "cutout_grid": "768x768"}.get(args.scene, "1920x1088")
    w, h = (int(v) for v in dim.split("x"))
    dev = torch.device("cuda")
    spl = args.spl or {"textured": 4, "knot_rig": 8, "cutouts": 32,
                       "cutout_grid": 8}.get(args.scene, 16)
    if args.scene == "cutouts":
        from optix_raytracer_tpu_torch.apps.cutouts import cutout_cornell
        scene = cutout_cornell(dev)
        cam = builtins.cornell_camera(w, h).params(dev)
        impls, depth = ("wavefront",), args.depth or 4
    elif args.scene == "cutout_grid":
        from optix_raytracer_tpu_torch.apps.cutouts import cutout_grid
        scene = cutout_grid(dev)
        cam = builtins.cutout_grid_camera(w, h).params(dev)
        impls, depth = ("spl",), args.depth or 3
    elif args.scene == "whitted":
        scene = builtins.whitted_scene(dev)
        cam = builtins.whitted_camera(w, h).params(dev)
        impls, depth = ("whitted",), args.depth or 6
    elif args.scene == "knot_rig":
        from optix_raytracer_tpu_torch.apps.meshviewer import headlight_rig
        host = builtins.knot_host_scene(200, 63)
        camera = host.default_camera(w, h)
        scene = host.finalize(dev, lights=headlight_rig(camera))
        cam = camera.params(dev)
        impls, depth = ("whitted",), args.depth or 3
    elif args.scene in ("knot", "knot4m"):
        _label_cull_stages()
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
        print(json.dumps(profile(args.scene, impl, scene, cam, w, h,
                                 spl, depth, args.out, args.qwalk)),
              flush=True)


if __name__ == "__main__":
    main()
