"""The host API's launches, the BVH walk past the cluster cap and the API's
six apps on the card: `chip_smoke.py`'s phases a1-a3.

- a1 (`pipeline_case`): a validation-mode `Pipeline.launch` of a scene
  assembled from a GAS and SBT records, warm-up then timed launches,
  bit-equal to the direct render (`render_accumulate` /
  `render_whitted_sample`) on the pipeline's own assembled scene, with
  equal ray counts and zero exception counters. The cases (`api_cases`):
  the Cornell box at the headline (1920x1088, 16 samples a launch, depth 4;
  the fused kernel), the Whitted scene (768x576, 4 samples a launch, depth
  6; kernels 1-2) and the 25k knot at the knot headline (kernels 4-6).
- a2 (`past_cap_case`): `knot_mesh(1500, 1420)`, 4,260,000 tube triangles
  and the floor, past the cluster tier's 4,194,304: `build_gas` builds its
  LBVH on the card (timed, beside the native SAH build on the host), a
  launch at 1920x1088, depth 3, one sample walks it (the walk kernel and
  no cluster kernel), and the walk kernel, closest and any-hit, is timed by
  CUDA events on the camera rays and their shadow rays and held bit for bit
  against the lock-step loop on the same rays, whose visit counts and
  touched rows give its bound.
- a3 (`run_apps`): the six apps at their default sizes through `main()`.

    python -m optix_raytracer_tpu_torch.tools.api_probe    # a1-a3 alone
"""
from __future__ import annotations

import io
import os
import time
from contextlib import redirect_stdout

import torch

from .. import api, kernels
from ..accel import native
from ..accel import traverse as trav
from ..accel.lbvh import build_lbvh
from ..core import rng as _rng
from ..core.camera import generate_rays
from ..core.film import Film
from ..core.rays import Rays
from ..scene import builtins as B
from ..shade.lights import ParallelogramLight
from ..wavefront.engine import render_accumulate
from ..wavefront.whitted import render_whitted_sample
from .knot_probe import KNOT, PAIR_OPS, SLAB_OPS, bound, cuda_ms

# The walk's bound counts the bytes the function must move, each once: a
# ray's origin, direction, tmin and tmax in; its hit row (t, prim, mat, uv,
# normal) or its occlusion byte out; and a node row, a tested triangle's
# Woop constants and a winner's normal and material id once for every row
# any ray touches. The bytes a visit reads (NODE_BYTES a node, WOOP_BYTES a
# leaf test), mostly the top of the tree again from L2, are reported apart
# as visit_bytes, not in the bound.
RAY_IN_BYTES = 32
HIT_OUT_BYTES = 32
OCC_OUT_BYTES = 1
NODE_BYTES = 32
WOOP_BYTES = 48
WINNER_BYTES = 16
# Path (d): past the cluster tier's 1024 x 32 x 128 = 4,194,304 triangles.
PAST_CAP = dict(segments=1500, sides=1420, width=1920, height=1088, depth=3)
ZERO_COUNTERS = {"invalid_ray": 0, "nonfinite_radiance": 0, "negative_radiance": 0}


def _records(materials, miss=(0.0, 0.0, 0.0)):
    mod = api.Module({}, name="pathtrace")
    groups = [api.ProgramGroup(api.ProgramGroupKind.RAYGEN, "__raygen__rg",
                               mod),
              api.ProgramGroup(api.ProgramGroupKind.MISS, "__miss__radiance",
                               mod),
              api.ProgramGroup(api.ProgramGroupKind.HITGROUP,
                               "__closesthit__radiance", mod)]
    sbt = api.ShaderBindingTable(
        raygen_record=api.SbtRecord(groups[0]),
        miss_records=[api.SbtRecord(groups[1], {"color": miss})],
        hitgroup_records=[api.SbtRecord(groups[2], m) for m in materials])
    return groups, sbt


def api_cases(device):
    """Phase a1's three launches through the API → {name: case dict}."""
    verts, idx, tri_mat = B.quads_to_triangles(B._CORNELL_QUADS)
    groups, sbt = _records(B.CORNELL_MATERIALS)
    cornell = dict(
        integrator="pathtrace", groups=groups, sbt=sbt,
        handle=api.build_gas(verts, idx, device=device), tri_mat=tri_mat,
        lights=(), area_light=ParallelogramLight.make(
            B.CORNELL_LIGHT_CORNER, B.CORNELL_LIGHT_V1, B.CORNELL_LIGHT_V2,
            B.CORNELL_LIGHT_EMISSION, device),
        camera=B.cornell_camera, width=1920, height=1088, spl=16, depth=4)
    groups, sbt = _records(B.WHITTED_MATERIALS, B.WHITTED_MISS)
    whitted = dict(
        integrator="whitted", groups=groups, sbt=sbt,
        handle=api.build_custom_gas(B.WHITTED_PRIMS, device=device),
        tri_mat=None, lights=B.WHITTED_LIGHTS, area_light=None,
        camera=B.whitted_camera, width=768, height=576, spl=4, depth=6)
    kv, ki, _, kmat, klight = B.knot_mesh(KNOT["segments"], KNOT["sides"])
    groups, sbt = _records(B.KNOT_MATERIALS)
    knot = dict(
        integrator="pathtrace", groups=groups, sbt=sbt,
        handle=api.build_gas(kv, ki, device=device), tri_mat=kmat,
        lights=(), area_light=ParallelogramLight.make(
            *klight, (10.0, 10.0, 10.0), device),
        camera=B.knot_camera, width=KNOT["width"], height=KNOT["height"],
        spl=KNOT["spl"], depth=KNOT["depth"])
    return {"cornell": cornell, "whitted": whitted, "knot25k": knot}


def _launch(pipe, case, cam, film=None):
    return pipe.launch(case["sbt"], case["handle"], cam, case["width"],
                       case["height"], film=film,
                       tri_sbt_index=case["tri_mat"], lights=case["lights"],
                       area_light=case["area_light"])


def _direct(scene, case, cam):
    """The same samples rendered straight from the assembled scene."""
    W, H, spl, depth = (case[k] for k in ("width", "height", "spl", "depth"))
    film = Film.create(H, W, scene.device)
    if case["integrator"] == "pathtrace":
        return render_accumulate(scene, cam, film, W, H,
                                 samples_per_launch=spl, max_depth=depth)
    rays = torch.zeros((), dtype=torch.int64, device=scene.device)
    for _ in range(spl):
        rad, r = render_whitted_sample(scene, cam, W, H, film.subframe,
                                       max_depth=depth)
        film, rays = film.accumulate(rad), rays + r
    return film, rays


def pipeline_case(case, device, launches: int = 2) -> dict:
    """A validation-mode pipeline: one warm-up launch (kernel launches
    counted on it alone), then `launches` timed ones, each on a new film
    and each with zero exception counters; the first film bit-equal to the
    direct render on the pipeline's assembled scene, ray counts equal → the
    phase's fields. (Each launch starts a film because the counters recover
    a launch's radiance sum from the films' running means, n1 accum1 - n0
    accum0, as the reference does: on a continued film that difference
    rounds below zero on pixels whose launch added ~0, and
    negative_radiance counts them.)"""
    errors = []
    ctx = api.DeviceContext(
        log_callback=lambda lvl, tag, msg: errors.append(msg),
        log_level=api.LogLevel.ERROR, validation_mode=True, device=device)
    pipe = api.Pipeline(context=ctx, program_groups=case["groups"],
                        integrator=case["integrator"],
                        max_trace_depth=case["depth"],
                        samples_per_launch=case["spl"])
    W, H = case["width"], case["height"]
    cam = case["camera"](W, H).params(device)
    torch.cuda.synchronize(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    first, first_rays = _launch(pipe, case, cam)
    torch.cuda.synchronize(device)
    first_s = time.perf_counter() - t0
    counts = {k: v for k, v in kernels.LAUNCHES.items() if v}
    checks = [pipe.last_exceptions]
    t0 = time.perf_counter()
    for _ in range(launches):
        film, _ = _launch(pipe, case, cam)
        checks.append(pipe.last_exceptions)
    torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    if errors or any(c != ZERO_COUNTERS for c in checks):
        raise RuntimeError(f"exception counters fired: {checks} {errors}")
    t0 = time.perf_counter()
    scene = pipe._assemble_scene(case["sbt"], case["handle"],
                                 case["tri_mat"], case["lights"],
                                 case["area_light"])
    torch.cuda.synchronize(device)
    assemble_s = time.perf_counter() - t0
    ref, ref_rays = _direct(scene, case, cam)
    if not torch.equal(first.accum, ref.accum):
        raise RuntimeError("the pipeline's image differs from the direct "
                           "render's")
    if int(first_rays) != int(ref_rays):
        raise RuntimeError(f"ray counts {int(first_rays)} != "
                           f"{int(ref_rays)}")
    img = film.accum
    if not (bool(torch.isfinite(img).all()) and float(img.mean()) > 0):
        raise RuntimeError("the image is not finite or empty")
    return dict(dim=f"{W}x{H}", spl=case["spl"], depth=case["depth"],
                integrator=case["integrator"],
                triangles=scene.num_triangles, prims=scene.prims.num,
                clusters=scene.has_clusters, bvh=scene.has_bvh,
                ms_per_launch=1e3 * dt / launches,
                ms_per_sample=1e3 * dt / (launches * case["spl"]),
                first_launch_ms=1e3 * first_s,
                assemble_ms=1e3 * assemble_s, rays_per_launch=int(first_rays),
                bit_equal_to_direct=True, exceptions=checks[-1],
                launches=counts)


def _camera_and_shadow_rays(scene, cam, W, H, device):
    """The jittered camera rays of subframe 0 and, from their closest hits
    (the walk kernel's), NEE-style shadow rays toward the light's centre (a
    miss gets tmax 0: dead)."""
    pix = torch.arange(W * H, dtype=torch.int64, device=device)
    rays, _ = generate_rays(cam, W, H,
                            rng_state=_rng.seed(pix, 0).reshape(H, W))
    rays = rays.reshape(W * H)
    hits = trav.walk_closest(scene.bvh, scene.geom.tri_consts, scene.tri_mat,
                             rays)
    p = rays.origin + hits["t"][:, None] * rays.direction
    light = scene.area_light
    delta = (light.corner + 0.5 * light.v1 + 0.5 * light.v2) - p
    dist = torch.linalg.vector_norm(delta, dim=1)
    shadow = Rays(origin=p, direction=delta / dist[:, None],
                  tmin=torch.full_like(dist, 1e-2),
                  tmax=torch.where(hits["prim_id"] >= 0, dist * 0.999, 0.0))
    return rays, shadow


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def walk_parity(scene, rays: Rays, closest: bool) -> dict:
    """The walk kernel on the whole wavefront (CUDA events, mean of 10)
    against the lock-step loop on the same rays, bit for bit; the loop's
    visits and leaf tests give the operations of the bound, the rows any
    ray touched its bytes (RAY_IN_BYTES above) → the kernels line's
    fields. plain_ms is a run of the loop without its counters."""
    bvh, tri = scene.bvh, scene.geom.tri_consts
    if closest:
        def run():
            return trav.walk_closest(bvh, tri, scene.tri_mat, rays)
    else:
        def run():
            return trav.walk_any(bvh, tri, rays)
    out = run()
    ms = cuda_ms(run, 10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = trav.walk_plain(bvh, tri, rays, any_hit=not closest)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    *again, visits, tests, node_seen, tri_seen = trav.walk_plain(
        bvh, tri, rays, any_hit=not closest, counts=True)
    if not all(torch.equal(_bits(a), _bits(b)) for a, b in zip(again,
                                                               plain)):
        raise RuntimeError("the lock-step loop is not deterministic")
    n = rays.tmin.shape[0]
    if closest:
        ref = trav._hits(scene.geom, scene.tri_mat, rays, *plain)
        err = 0.0
        for k in ("t", "prim_id", "mat_id", "uv", "normal"):
            a, b = out[k], getattr(ref, k)
            if not torch.equal(_bits(a), _bits(b)):
                raise RuntimeError(f"bvh_walk_closest: {k} differs from the "
                                   f"lock-step loop")
            if a.dtype == torch.float32:
                err = max(err, float((a - b).abs().nan_to_num().max()))
        hit = out["prim_id"] >= 0
        winners = int(torch.unique(out["prim_id"][hit]).numel())
        out_bytes = HIT_OUT_BYTES * n + WINNER_BYTES * winners
        hits = int(hit.sum())
    else:
        if not torch.equal(out, plain[0]):
            raise RuntimeError("bvh_walk_any: occlusion differs from the "
                               "lock-step loop")
        err = float((out != plain[0]).sum())
        out_bytes, hits = OCC_OUT_BYTES * n, int(out.sum())
    # a dead lane (tmax <= tmin) visits the root in the loop, none in the
    # kernel
    walks = rays.tmax > rays.tmin
    v_all = int(visits[walks].sum())
    t_all = int(tests[walks].sum())
    nodes, tris = int(node_seen.sum()), int(tri_seen.sum())
    b = bound(SLAB_OPS * v_all + PAIR_OPS * t_all,
              RAY_IN_BYTES * n + out_bytes + NODE_BYTES * nodes
              + WOOP_BYTES * tris)
    return dict(rays=n, hits=hits, ms=ms, plain_ms=plain_ms,
                visits_per_ray=v_all / n, leaf_tests_per_ray=t_all / n,
                max_visits=int(visits.max()), distinct_nodes=nodes,
                distinct_tris=tris,
                visit_bytes=NODE_BYTES * v_all + WOOP_BYTES * t_all,
                max_abs_err=err, **b)


def past_cap_case(device, record: dict) -> dict:
    """Path (d) → the phase's fields, with "launches" the kernel launches of
    the timed launch alone (set to 0 just before it, read just after); the
    walk kernels' rows of the kernels line go to `record`."""
    cfg = PAST_CAP
    W, H, depth = cfg["width"], cfg["height"], cfg["depth"]
    verts, idx, _, tri_mat, light = B.knot_mesh(cfg["segments"],
                                                cfg["sides"])
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    handle = api.build_gas(verts, idx, device=device)
    torch.cuda.synchronize(device)
    gas_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = build_lbvh(handle.geom)
    torch.cuda.synchronize(device)
    lbvh_s = time.perf_counter() - t0
    if not torch.equal(again.nodes.view(torch.int32),
                       handle.bvh.nodes.view(torch.int32)):
        raise RuntimeError("the LBVH build is not deterministic")
    del again
    t0 = time.perf_counter()
    sah = native.build_bvh_sah(handle.geom)
    sah_s = time.perf_counter() - t0
    del sah
    groups, sbt = _records(B.KNOT_MATERIALS)
    case = dict(sbt=sbt, handle=handle, tri_mat=tri_mat, lights=(),
                area_light=ParallelogramLight.make(*light, (10.0, 10.0, 10.0),
                                                   device),
                width=W, height=H)
    ctx = api.DeviceContext(validation_mode=True, device=device)
    pipe = api.Pipeline(context=ctx, program_groups=groups,
                        max_trace_depth=depth, samples_per_launch=1)
    cam = B.knot_camera(W, H).params(device)
    film, _ = _launch(pipe, case, cam)                   # warm-up
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    film, rays = _launch(pipe, case, cam, film)
    torch.cuda.synchronize(device)
    launch_s = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    if pipe.last_exceptions != ZERO_COUNTERS:
        raise RuntimeError(f"exception counters fired: "
                           f"{pipe.last_exceptions}")
    others = {k: v for k, v in counts.items()
              if v and not k.startswith("bvh_walk")}
    if not (counts["bvh_walk_closest"] and counts["bvh_walk_any"]) or any(
            k.startswith(("cluster", "qwalk")) for k in others):
        raise RuntimeError(f"the launch past the cap ran {counts}")
    img = film.accum
    if not (bool(torch.isfinite(img).all()) and float(img.mean()) > 0):
        raise RuntimeError("the image is not finite or empty")
    scene = pipe._assemble_scene(sbt, handle, tri_mat, (),
                                 case["area_light"])
    cam_rays, shadow = _camera_and_shadow_rays(scene, cam, W, H, device)
    for name, rays_, closest in (("bvh_walk_closest", cam_rays, True),
                                 ("bvh_walk_any", shadow, False)):
        record[name] = walk_parity(scene, rays_, closest)
    return dict(triangles=scene.num_triangles, nodes=handle.bvh.num_nodes,
                clusters=scene.has_clusters, gas_build_ms=1e3 * gas_s,
                lbvh_build_ms=1e3 * lbvh_s, native_sah_build_ms=1e3 * sah_s,
                dim=f"{W}x{H}", depth=depth, spl=1,
                ms_per_sample=1e3 * launch_s, rays=int(rays),
                mrays_per_s=int(rays) / launch_s / 1e6,
                peak_mem_mib=torch.cuda.max_memory_allocated(device) / 2**20,
                launches={k: v for k, v in counts.items() if v})


# a3: each app's main() arguments at its defaults and what one run renders
APPS = (("sphere", ["--file", "sphere.ppm"], 1),
        ("callable_programs", ["--shade", "all", "--file",
                               "callable_programs.ppm"], 3),
        ("bound_values", ["--compare", "--file", "bound_values.ppm"], 2),
        ("dynamic_geometry", ["--file", "dynamic.ppm"], 4),
        ("dynamic_geometry", ["--ias", "--file", "dynamic_ias.ppm"], 4),
        ("compile_with_tasks", [], 4),
        ("module_create_abort", ["--file", "module_create_abort.ppm"], 1))


def run_apps(out_dir, device) -> list:
    """Each app through main() on `device`, writing into out_dir → per run
    dict(app, args, seconds, ms per frame / sample / job, files, its last
    printed line, kernel launches)."""
    import importlib
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for name, args, frames in APPS:
        app = importlib.import_module(f"optix_raytracer_tpu_torch.apps.{name}")
        argv = [os.path.join(out_dir, a) if a.endswith(".ppm") else a
                for a in args] + ["--device", str(device)]
        before = set(os.listdir(out_dir))
        torch.cuda.synchronize(device)
        kernels.reset_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with redirect_stdout(buf):
            app.main(argv)
        torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        files = sorted(set(os.listdir(out_dir)) - before) or [
            a for a in args if a.endswith(".ppm")]
        sizes = {f: os.path.getsize(os.path.join(out_dir, f)) for f in files}
        if name != "compile_with_tasks" and not all(sizes.values()):
            raise RuntimeError(f"{name}: no image written")
        rows.append(dict(app=name, args=" ".join(args), seconds=dt,
                         ms_per_unit=1e3 * dt / frames, units=frames,
                         files=sizes,
                         said=buf.getvalue().strip().splitlines()[-1],
                         launches={k: v for k, v in kernels.LAUNCHES.items()
                                   if v}))
    return rows


def main():
    dev = torch.device("cuda", 0)
    for name, case in api_cases(dev).items():
        print(name, pipeline_case(case, dev))
    record = {}
    print("past cap", past_cap_case(dev, record))
    print(record)
    for row in run_apps(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "_build", "apps"), dev):
        print(row)


if __name__ == "__main__":
    main()
