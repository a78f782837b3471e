#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (optix_raytracer_tpu_torch) on one
CUDA card: builds the hand-written kernels from this checkout, checks each
against its plain PyTorch version, checks the renderer against the JAX
package's engine semantics and the committed numpy-oracle pair, then times
the two main paths: the Cornell headline launch (1920x1088, 16 samples per
launch, depth 4; kernels 1-3) and the large-mesh launch (the 25,202-triangle
trefoil-knot scene, 1920x1088, 16 samples per launch, depth 3; kernels 4-6,
the cluster-culled traversal), whose kernels are also held against their
plain versions on the 25k knot and on a 500k-triangle knot.

    python3 chip_smoke.py

Every phase passes or raises (non-zero exit). The second-to-last line is
the kernels' JSON record; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result. Imports no JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
ORACLE = os.path.join(ROOT, "tools", "oracle_cache",
                      "cornell_d256x256_spp928_depth4_seed{}.npz")
ATOL, RTOL = 2e-3, 1e-3          # tests/test_fused_kernel.py:77-78
HEADLINE = dict(width=1920, height=1088, spl=16, depth=4)   # bench.py:18-21
# bench.py:299-304 (mesh, frame, depth) on the lit builtin knot_scene
KNOT = dict(segments=200, sides=63, width=1920, height=1088, spl=16,
            depth=3)
KNOT_STREAM = dict(segments=1000, sides=250)                # bench.py:124
# List entries (block x cluster pairs, 32,768 ray-triangle tests each) past
# which the plain walks run on a subset of blocks (about 2 s on the card).
PLAIN_WALK_ENTRIES = 200_000


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase(name, **fields):
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def to_np(t):
    return t.detach().cpu().numpy()


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps launches, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare_hits(out, ref, what):
    """Kernel-1 bars of tests/test_pallas_intersect.py:37-45; returns the max
    absolute difference over the float outputs of hit rays."""
    for k in ("prim_id", "mat_id"):
        require(np.array_equal(to_np(out[k]), to_np(ref[k])),
                f"{what}: {k} differs from the plain version")
    hit = to_np(ref["prim_id"]) >= 0
    require(hit.any() and (~hit).any(), f"{what}: degenerate test rays")
    err = 0.0
    for k, tol in (("t", dict(rtol=1e-5, atol=0)),
                   ("uv", dict(rtol=0, atol=1e-4)),
                   ("normal", dict(rtol=0, atol=1e-5))):
        a, b = to_np(out[k])[hit], to_np(ref[k])[hit]
        require(np.allclose(a, b, **tol), f"{what}: {k} outside {tol}")
        err = max(err, float(np.abs(a - b).max()))
    return err


def random_case(device, num_tris=40, n_rays=1500, seed=7):
    """A random mesh with one degenerate triangle and rays around it."""
    import torch
    from optix_raytracer_tpu_torch.accel.geometry import build_triangle_geometry
    from optix_raytracer_tpu_torch.core.rays import Rays
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (num_tris, 3))
    verts = np.concatenate([v0, v0 + rng.uniform(-1, 1, (num_tris, 3)),
                            v0 + rng.uniform(-1, 1, (num_tris, 3))])
    idx = np.arange(3 * num_tris).reshape(3, num_tris).T.copy()
    idx[17, 2] = idx[17, 1]
    geom = build_triangle_geometry(verts.astype(np.float32),
                                   idx.astype(np.int32), device)
    require(not bool(geom.valid[17]), "degenerate triangle not flagged")
    tri_mat = torch.as_tensor(rng.integers(0, 5, num_tris).astype(np.int32),
                              device=device)
    o = rng.uniform(-3, 3, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays.make(torch.as_tensor(o, device=device),
                     torch.as_tensor(d, device=device), tmin=1e-3, tmax=50.0)
    return geom, tri_mat, rays


def camera_and_shadow_rays(scene, width, height, device):
    """Jittered Cornell camera rays of subframe 0, and NEE-style shadow rays
    from their closest hits toward the light's centre."""
    import torch
    from optix_raytracer_tpu_torch.accel import pallas_bf
    from optix_raytracer_tpu_torch.core import rng as _rng
    from optix_raytracer_tpu_torch.core.camera import generate_rays
    from optix_raytracer_tpu_torch.core.rays import Rays
    from optix_raytracer_tpu_torch.scene.builtins import cornell_camera
    cam = cornell_camera(width, height).params(device)
    pix = torch.arange(width * height, dtype=torch.int64, device=device)
    state = _rng.seed(pix, 0).reshape(height, width)
    rays, _ = generate_rays(cam, width, height, rng_state=state)
    rays = rays.reshape(width * height)
    hits = pallas_bf.closest_hit_plain(scene.geom.tri_consts, scene.tri_mat,
                                       rays)
    p = rays.origin + hits["t"][:, None] * rays.direction
    light = scene.area_light
    target = light.corner + 0.5 * light.v1 + 0.5 * light.v2
    delta = target - p
    dist = torch.linalg.vector_norm(delta, dim=1)
    wi = delta / dist[:, None]
    shadow = Rays(origin=p, direction=wi,
                  tmin=torch.full_like(dist, 1e-2),
                  tmax=torch.where(hits["prim_id"] >= 0, dist * 0.999, 0.0))
    return rays, shadow


def srgb64(x):
    import torch
    from optix_raytracer_tpu_torch.core.film import linear_to_srgb
    return to_np(linear_to_srgb(torch.as_tensor(np.clip(x, 0.0, 1.0),
                                                dtype=torch.float64)))


def render_mean(scene, cam, size, spp, subframe0, device, spl=256):
    """Mean radiance over subframes [subframe0, subframe0 + spp), as
    tools/run_rmse_gate.py::engine_render computes it."""
    import torch
    from optix_raytracer_tpu_torch.core.film import Film
    from optix_raytracer_tpu_torch.wavefront.engine import render_accumulate
    film = Film.create(size, size, device)
    film.subframe = torch.full((), subframe0, dtype=torch.int64,
                               device=device)
    done = 0
    while done < spp:
        n = min(spl, spp - done)
        film, _ = render_accumulate(scene, cam, film, size, size,
                                    samples_per_launch=n, max_depth=4,
                                    impl="auto")
        done += n
    return to_np(film.accum).astype(np.float64) * (subframe0 + spp) / spp


def timed_launches(scene, cam, W, H, spl, depth, impl, launches, dev):
    """One warm-up launch from subframe 0, then `launches` timed launches
    continuing its film → (film, rays of the timed launches, seconds, peak
    bytes, first film, rays of the first launch, kernel launch counts of
    this path alone: set to 0 just before its first launch, read just after
    its last)."""
    import torch
    from optix_raytracer_tpu_torch import kernels
    from optix_raytracer_tpu_torch.core.film import Film
    from optix_raytracer_tpu_torch.wavefront.engine import render_accumulate
    kernels.reset_launches()
    first, first_rays = render_accumulate(
        scene, cam, Film.create(H, W, dev), W, H, spl, depth, impl=impl)
    film = first
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    rays = []
    t0 = time.perf_counter()
    for _ in range(launches):
        film, r = render_accumulate(scene, cam, film, W, H, spl, depth,
                                    impl=impl)
        rays.append(r)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    return (film, int(sum(int(r) for r in rays)), dt,
            torch.cuda.max_memory_allocated(dev), first, int(first_rays),
            counts)


def tile_order(width, height):
    """Pixel permutation into 16x16 tiles, row-major inside each
    (bench.py:50-56)."""
    yy, xx = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    key = (((yy // 16) * (width // 16) + (xx // 16)).ravel() * 256
           + ((yy % 16) * 16 + (xx % 16)).ravel())
    return np.argsort(key, kind="stable")


def knot_ray_sets(scene, width, height, device):
    """Phase (b)'s ray sets: unjittered knot-camera primaries in tile order;
    NEE-style shadow rays from their hits toward the light's centre (dead
    where the primary missed); and the bounce-1 wavefront (a cosine-sampled
    diffuse bounce from each hit, seeded per pixel) sorted by
    coherence_key."""
    import torch
    from optix_raytracer_tpu_torch.accel import clusters
    from optix_raytracer_tpu_torch.core import rng as _rng
    from optix_raytracer_tpu_torch.core.camera import generate_rays
    from optix_raytracer_tpu_torch.core.rays import Rays
    from optix_raytracer_tpu_torch.core.vecmath import dot
    from optix_raytracer_tpu_torch.scene.builtins import knot_camera
    from optix_raytracer_tpu_torch.shade.sampling import (
        cosine_sample_hemisphere)

    def permute(r, perm):
        return Rays(origin=r.origin[perm], direction=r.direction[perm],
                    tmin=r.tmin[perm], tmax=r.tmax[perm])

    n = width * height
    cam = knot_camera(width, height).params(device)
    rays, _ = generate_rays(cam, width, height, rng_state=None, jitter=False)
    prim = permute(rays.reshape(n),
                   torch.as_tensor(tile_order(width, height), device=device))
    hits = clusters.closest_hit(scene.clusters, prim)
    p = prim.at(hits.t)
    light = scene.area_light
    delta = light.corner + 0.5 * light.v1 + 0.5 * light.v2 - p
    dist = torch.sqrt(dot(delta, delta))
    shadow = Rays(origin=p, direction=delta / dist[:, None],
                  tmin=torch.full_like(dist, 1e-2),
                  tmax=torch.where(hits.valid, dist * 0.999, 0.0))
    nrm = hits.normal * torch.sign(-dot(hits.normal, prim.direction))[:, None]
    u1, u2, _ = _rng.uniform2(_rng.seed(torch.arange(n, device=device), 0))
    bounce = Rays(origin=p + nrm * 1e-2,
                  direction=cosine_sample_hemisphere(u1, u2, nrm),
                  tmin=torch.full_like(dist, 1e-2),
                  tmax=torch.where(hits.valid, 1e16, 0.0))
    order = torch.argsort(clusters.coherence_key(scene.clusters, bounce),
                          stable=True)
    return prim, shadow, permute(bounce, order)


def main_path_strip_sets(scene, cam, width, height, spl, depth):
    """The rays the knot's main path hands kernels 4-6 in one sample-major
    strip: render_sample_group at render_sum_sample_major's strip height
    (136 rows x 1920 x 16 samples = 4,177,920 lanes), the middle strip of
    the frame, subframe 0. Each cluster query of the strip is recorded as
    (rays, exact, group_walk) → (closest-hit calls, any-hit calls), one
    per bounce."""
    from optix_raytracer_tpu_torch.accel import clusters as C
    from optix_raytracer_tpu_torch.wavefront import engine
    rows = min(height, max(1, engine._SPL_TILE_RAYS // (width * spl)))
    strip = (-(-height // rows)) // 2
    calls = dict(closest_hit=[], any_hit=[])
    query = {name: getattr(C, name) for name in calls}

    def recorder(name):
        def call(cl, rays, exact=False, group_walk=False):
            calls[name].append((rays, exact, group_walk))
            return query[name](cl, rays, exact=exact, group_walk=group_walk)
        return call

    try:
        for name in calls:
            setattr(C, name, recorder(name))
        engine.render_sample_group(scene, cam, width, rows, 0, spl,
                                   max_depth=depth, y0=strip * rows,
                                   full_width=width, full_height=height)
    finally:
        for name, fn in query.items():
            setattr(C, name, fn)
    require(all(len(c) == depth for c in calls.values()),
            "the strip did not query the cluster table once per bounce")
    return calls["closest_hit"], calls["any_hit"]


def hits_dict(h):
    return {f: getattr(h, f) for f in ("t", "prim_id", "mat_id", "uv",
                                       "normal")}


def cluster_parity(cl, rays, exact, gate, what):
    """Kernels 4-6 against their plain versions on one ray set: the exact
    cull's tn / gm and the compacted counts / lists / bounds bit-equal, the
    walks' hits within compare_hits and their occlusion equal. Returns the
    errors and the CUDA-event times (kernel and plain, on the same inputs).

    The plain walks test every listed (ray block, cluster) pair with torch
    ops; past PLAIN_WALK_ENTRIES list entries both walks are compared and
    timed on every k-th block only (`walk_blocks` says how many), and the
    kernels' time on all blocks is reported beside it."""
    import torch
    from optix_raytracer_tpu_torch.accel import clusters as C
    n = rays.tmin.shape[0]
    n_padded = C._padded(n)
    packed = C._pack_rays(rays, n_padded)
    n_blocks, n_super, c_pad = n_padded // C.SUB, n_padded // C.SUPER, cl.c_pad
    out = dict(cull_err=0.0)
    if exact and c_pad <= C.MAX_CLUSTERS:
        tn_k, gm_k = C.exact_cull(cl.aabb, packed, n_blocks, c_pad)
        tn_p, gm_p = C.exact_cull_plain(cl.aabb, packed, n_blocks, c_pad)
        require(torch.equal(tn_k.view(torch.int32), tn_p.view(torch.int32))
                and torch.equal(gm_k, gm_p), f"{what}: exact cull differs")
        culled = C._compact(cl, *C._cull_tables(tn_k, gm_k), n_super)
        culled_p = C._compact(cl, *C._cull_tables(tn_p, gm_p), n_super)
        require(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                    for a, b in zip(culled, culled_p)),
                f"{what}: counts / lists / bounds differ")
        out.update(
            cull_ms=cuda_ms(lambda: C.exact_cull(cl.aabb, packed, n_blocks,
                                                 c_pad), 10),
            cull_plain_ms=cuda_ms(lambda: C.exact_cull_plain(
                cl.aabb, packed, n_blocks, c_pad), 1))
    else:
        culled = C._cull(cl, packed, n_super, c_pad, exact=exact)
    counts, lists, tnear = (t.reshape(n_blocks, -1) for t in culled)
    full = (counts, lists, tnear, cl.comp, packed)
    entries = int(counts.sum())
    stride = max(1, -(-entries // PLAIN_WALK_ENTRIES))
    if stride > 1:
        blocks = torch.arange(0, n_blocks, stride, device=packed.device)
        part = (counts[blocks].contiguous(), lists[blocks].contiguous(),
                tnear[blocks].contiguous(), cl.comp,
                packed.reshape(n_blocks, C.SUB, 8)[blocks].reshape(-1, 8)
                .contiguous())
    else:
        blocks, part = None, full
    tmax = part[4][:, 7]
    live = torch.repeat_interleave(part[0].reshape(-1) > 0, C.SUB)

    def hits(rows):
        return hits_dict(C._hits_from_rows(rows, live, tmax))

    rows_k = C.walk_closest(*part, gate)
    rows_p = C.walk_closest_plain(*part, gate)
    out["closest_err"] = compare_hits(hits(rows_k), hits(rows_p), what)
    out["rows_bit_equal"] = bool(torch.equal(rows_k, rows_p))
    occ_k, occ_p = C.walk_any(*part, gate), C.walk_any_plain(*part, gate)
    out["any_mismatches"] = int((occ_k != occ_p).sum())
    require(out["any_mismatches"] == 0, f"{what}: occlusion differs")
    out["occluded"] = int(occ_k.sum())
    out["mean_clusters_per_block"] = entries / n_blocks
    out["walk_blocks"] = (f"{part[0].shape[0]} of {n_blocks}"
                          if blocks is not None else "all")
    out.update(
        closest_ms=cuda_ms(lambda: C.walk_closest(*part, gate), 10),
        closest_plain_ms=cuda_ms(lambda: C.walk_closest_plain(*part, gate),
                                 1),
        any_ms=cuda_ms(lambda: C.walk_any(*part, gate), 10),
        any_plain_ms=cuda_ms(lambda: C.walk_any_plain(*part, gate), 1))
    if blocks is not None:
        out.update(
            closest_all_blocks_ms=cuda_ms(lambda: C.walk_closest(*full, gate),
                                          10),
            any_all_blocks_ms=cuda_ms(lambda: C.walk_any(*full, gate), 10))
    return out


def knot_phases(dev, card, record):
    """Phases (a)-(d): the knot build, kernels 4-6 against their plain
    versions on the 25k knot (probe sets and the main path's own strip
    queries) and the 500k knot, and the knot headline launch (sample-major
    against the sequential oracle) with its launches counted per path.
    Returns the launch counts of the sample-major (auto) path."""
    import torch
    from optix_raytracer_tpu_torch.accel import clusters as C
    from optix_raytracer_tpu_torch.accel import native
    from optix_raytracer_tpu_torch.accel.geometry import build_triangle_geometry
    from optix_raytracer_tpu_torch.scene.builtins import (knot_camera,
                                                         knot_scene,
                                                         trefoil_mesh)

    # --- (a) the knot build ---
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene = knot_scene(KNOT["segments"], KNOT["sides"], device=dev)
    torch.cuda.synchronize()
    cl = scene.clusters
    order = "sah" if native.available() else "morton"
    phase("a knot build", triangles=scene.num_triangles,
          clusters=cl.num_clusters, c_pad=cl.c_pad, order=order,
          build_s=f"{time.perf_counter() - t0:.2f}")
    require(cl.num_clusters == -(-scene.num_triangles // C.LANES),
            "cluster count")
    require(order == "sah", "no SAH builder: the knot took the morton order")

    # --- (b) kernels 4-6 vs plain on the 25k knot at 1920x1088 ---
    W, H = KNOT["width"], KNOT["height"]
    prim, shadow, bounce = knot_ray_sets(scene, W, H, dev)
    sets = (("primary", prim, False, False), ("shadow", shadow, True, False),
            ("bounce1", bounce, True, False),
            ("bounce1_gated", bounce, True, True))
    res = {}
    for name, rays, exact, gate in sets:
        res[name] = r = cluster_parity(cl, rays, exact, gate,
                                       f"knot25k {name}")
        phase(f"b knot25k {name}", rays=W * H, exact=exact, gated=gate,
              **{k: (f"{v:.3f}" if isinstance(v, float) and k.endswith("ms")
                     else v) for k, v in r.items()})
    stats = C.traversal_stats(cl, prim)
    del prim, shadow, bounce

    # the main path's own inputs: every cluster query of one sample-major
    # strip of the knot headline, with the cull and gating it asked for
    cam = knot_camera(W, H).params(dev)
    spl, depth = KNOT["spl"], KNOT["depth"]
    closest_calls, any_calls = main_path_strip_sets(scene, cam, W, H, spl,
                                                    depth)
    for bounce, ((rc, ec, gc), (ra, ea, ga)) in enumerate(
            zip(closest_calls, any_calls)):
        require(ec == (bounce > 0) and gc and ea and ga,
                f"strip bounce {bounce}: unexpected cull / gating flags")
        # the walk is gated only behind the exact cull (_closest_core)
        for name, rays, exact, gate in (
                (f"strip_bounce{bounce}", rc, ec, ec and gc),
                (f"strip_bounce{bounce}_shadow", ra, ea, ga)):
            res[name] = r = cluster_parity(cl, rays, exact, gate,
                                           f"knot25k {name}")
            phase(f"b knot25k {name}", rays=rays.tmin.shape[0], exact=exact,
                  gated=gate,
                  **{k: (f"{v:.3f}" if isinstance(v, float)
                         and k.endswith("ms") else v) for k, v in r.items()})
    del closest_calls, any_calls, rc, ra, rays
    # kernel times of the JSON record: the strip's bounce-1 queries
    record["cluster_cull_exact"] = dict(
        max_abs_err=max(r["cull_err"] for r in res.values()),
        ms=res["strip_bounce1"]["cull_ms"],
        plain_ms=res["strip_bounce1"]["cull_plain_ms"])
    record["cluster_closest"] = dict(
        max_abs_err=max(r["closest_err"] for r in res.values()),
        ms=res["strip_bounce1"]["closest_ms"],
        plain_ms=res["strip_bounce1"]["closest_plain_ms"])
    record["cluster_any"] = dict(
        max_abs_err=float(max(r["any_mismatches"] for r in res.values())),
        ms=res["strip_bounce1_shadow"]["any_ms"],
        plain_ms=res["strip_bounce1_shadow"]["any_plain_ms"])

    # --- (c) the streaming tier: a 500k-triangle knot ---
    t0 = time.perf_counter()
    verts, idx, normals = trefoil_mesh(KNOT_STREAM["segments"],
                                       KNOT_STREAM["sides"])
    geom = build_triangle_geometry(verts, idx, dev, normals=normals)
    big = C.build_clusters(geom, order=native.sah_leaf_order(geom))
    torch.cuda.synchronize()
    require(big.num_clusters > C.MAX_CLUSTERS, "500k knot is not streamed")
    phase("c knot500k build", triangles=geom.num_triangles,
          clusters=big.num_clusters, c_pad=big.c_pad,
          id_bits=10 if big.c_pad <= 1024 else 13,
          build_s=f"{time.perf_counter() - t0:.2f}")
    bprim, bshadow, _ = knot_ray_sets(
        dataclasses.replace(scene, clusters=big), W, H, dev)
    for name, rays, exact in (("primary", bprim, False),
                              ("shadow", bshadow, True)):
        r = cluster_parity(big, rays, exact, False, f"knot500k {name}")
        record["cluster_closest"]["max_abs_err"] = max(
            record["cluster_closest"]["max_abs_err"], r["closest_err"])
        record["cluster_any"]["max_abs_err"] = max(
            record["cluster_any"]["max_abs_err"], float(r["any_mismatches"]))
        phase(f"c knot500k {name}", rays=W * H, exact_requested=exact,
              **{k: (f"{v:.3f}" if isinstance(v, float) and k.endswith("ms")
                     else v) for k, v in r.items()})
    del big, geom, bprim, bshadow

    # --- (d) the knot headline: sample-major vs the sequential oracle,
    # launches counted per path ---
    film, rays_a, dt_a, peak_a, first_a, first_rays_a, n_a = timed_launches(
        scene, cam, W, H, spl, depth, "auto", 2, dev)
    _, rays_w, dt_w, peak_w, first_w, first_rays_w, n_w = timed_launches(
        scene, cam, W, H, spl, depth, "wavefront", 1, dev)
    names = ("cluster_cull_exact", "cluster_closest", "cluster_any")
    for name in names:
        require(n_a[name] > 0, f"{name} never launched on the knot's "
                               f"sample-major (auto) path")
        require(n_w[name] > 0, f"{name} never launched on the knot's "
                               f"sequential (wavefront) path")
    a, b = to_np(first_a.accum), to_np(first_w.accum)
    require(first_rays_a == first_rays_w,
            f"knot ray counts differ: {first_rays_a} vs {first_rays_w}")
    require(np.allclose(a, b, atol=ATOL, rtol=RTOL),
            f"knot images differ by {np.abs(a - b).max()}")
    img = to_np(film.accum)
    require(img.shape == (H, W, 3) and np.isfinite(img).all()
            and img.mean() > 0, "knot image not finite / empty")
    phase("d knot headline", card=repr(card), dim=f"{W}x{H}", spl=spl,
          depth=depth, triangles=scene.num_triangles,
          mrays_per_s=f"{rays_a / dt_a / 1e6:.1f}",
          msamples_per_s=f"{2 * W * H * spl / dt_a / 1e6:.1f}",
          rays_per_launch=rays_a // 2, ms_per_launch=f"{1e3 * dt_a / 2:.2f}",
          peak_mem_mib=f"{peak_a / 2**20:.0f}",
          wavefront_ms_per_launch=f"{1e3 * dt_w:.2f}",
          wavefront_mrays_per_s=f"{rays_w / dt_w / 1e6:.1f}",
          wavefront_peak_mem_mib=f"{peak_w / 2**20:.0f}",
          first_launch_rays=first_rays_a,
          auto_vs_wavefront_max_abs_diff=float(np.abs(a - b).max()),
          pixels_bit_equal=f"{np.mean(np.all(a == b, axis=-1)):.6f}",
          image_mean=f"{img.mean():.5f}",
          mean_clusters_per_block=f"{stats['mean_clusters_per_block']:.2f}",
          auto_launches={k: n_a[k] for k in names},
          wavefront_launches={k: n_w[k] for k in names})
    return {k: n_a[k] for k in names}


def main():
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this smoke test runs on a GPU")
    if not os.path.isdir(os.path.join(ROOT, "optix_raytracer_tpu_torch")):
        raise SmokeFailure("optix_raytracer_tpu_torch/ not found: run from "
                           "a checkout of the repository")
    sys.path.insert(0, ROOT)
    from optix_raytracer_tpu_torch import kernels
    from optix_raytracer_tpu_torch.accel import pallas_bf
    from optix_raytracer_tpu_torch.core.film import Film
    from optix_raytracer_tpu_torch.scene.builtins import (cornell_box,
                                                         cornell_camera)
    from optix_raytracer_tpu_torch.wavefront import pallas_pt
    from optix_raytracer_tpu_torch.wavefront.engine import render_accumulate

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- phase 1: device and build ---
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    lib_path, build_s = kernels.build()
    kernels.lib()
    phase("1 device", card=repr(card), torch=torch.__version__,
          cuda=torch.version.cuda, kernel_build_s=f"{build_s:.1f}")
    log = lib_path.parent / "nvcc.log"
    if log.exists():   # ptxas: registers, shared memory, spills per kernel
        for line in log.read_text().splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print("  " + line.strip(), flush=True)
    record = {}

    # --- phase 2: kernels 1 and 2 vs their plain versions ---
    geom, tri_mat, rays = random_case(dev)
    e1 = compare_hits(pallas_bf.closest_hit(geom.tri_consts, tri_mat, rays),
                      pallas_bf.closest_hit_plain(geom.tri_consts, tri_mat,
                                                  rays), "random mesh")
    occ_k = to_np(pallas_bf.any_hit(geom.tri_consts, rays))
    occ_p = to_np(pallas_bf.any_hit_plain(geom.tri_consts, rays))
    require(np.array_equal(occ_k, occ_p), "random mesh: occlusion differs")
    scene = cornell_box(dev)
    cam_rays, shadow = camera_and_shadow_rays(scene, 256, 256, dev)
    e2 = compare_hits(
        pallas_bf.closest_hit(scene.geom.tri_consts, scene.tri_mat, cam_rays),
        pallas_bf.closest_hit_plain(scene.geom.tri_consts, scene.tri_mat,
                                    cam_rays), "cornell 256^2")
    occ2_k = to_np(pallas_bf.any_hit(scene.geom.tri_consts, shadow))
    occ2_p = to_np(pallas_bf.any_hit_plain(scene.geom.tri_consts, shadow))
    require(np.array_equal(occ2_k, occ2_p), "cornell: occlusion differs")
    record["bf_closest"] = dict(max_abs_err=max(e1, e2))
    record["bf_any"] = dict(max_abs_err=float(max(
        np.abs(occ_k.astype(int) - occ_p).max(),
        np.abs(occ2_k.astype(int) - occ2_p).max())))
    phase("2 bf kernels", closest_max_abs_err=max(e1, e2),
          any_mismatches=int((occ_k != occ_p).sum() + (occ2_k != occ2_p).sum()),
          cornell_occluded=int(occ2_k.sum()), rays=1500 + 256 * 256)

    # --- phase 3: kernel 3 vs its plain version, 64^2, spl 2, depth 2 ---
    w = h = 64
    cam = cornell_camera(w, h).params(dev)
    sub = torch.tensor(5, dtype=torch.int64, device=dev)
    out, c_k = pallas_pt.render_sum_fused(scene, cam, w, h, sub,
                                          samples_per_launch=2, max_depth=2)
    ref, c_p = pallas_pt.render_sum_plain(scene, cam, w, h, sub,
                                          samples_per_launch=2, max_depth=2)
    out, ref = to_np(out), to_np(ref)
    require(int(c_k) == int(c_p), f"ray counts {int(c_k)} != {int(c_p)}")
    require(np.allclose(out, ref, atol=ATOL, rtol=RTOL),
            f"radiance off by {np.abs(out - ref).max()}")
    halves = [to_np(pallas_pt.render_sum_fused(
        scene, cam, w, h // 2, sub, samples_per_launch=2, max_depth=2,
        y0=y0, full_width=w, full_height=h)[0]) for y0 in (0, h // 2)]
    require(np.array_equal(np.concatenate(halves), out),
            "row tiles differ from the full frame")
    record["pt_fused_cornell"] = dict(max_abs_err=float(np.abs(out - ref).max()))
    phase("3 fused kernel", rays=int(c_k), max_abs_err=np.abs(out - ref).max(),
          row_tiles="equal")

    # --- phase 4: fused vs wavefront launch, 256^2, spl 4, depth 4 ---
    w = h = 256
    cam = cornell_camera(w, h).params(dev)
    f_fused, r_fused = render_accumulate(scene, cam, Film.create(h, w, dev),
                                         w, h, samples_per_launch=4,
                                         max_depth=4, impl="fused")
    f_wave, r_wave = render_accumulate(scene, cam, Film.create(h, w, dev),
                                       w, h, samples_per_launch=4,
                                       max_depth=4, impl="wavefront")
    a, b = to_np(f_fused.accum), to_np(f_wave.accum)
    diff = np.abs(a - b)
    phase("4 fused vs wavefront", max_abs_diff=diff.max(),
          mean_abs_diff=diff.mean(), rays_fused=int(r_fused),
          rays_wavefront=int(r_wave))
    require(int(r_fused) == int(r_wave), "fused and wavefront ray counts differ")
    require(np.allclose(a, b, atol=ATOL, rtol=RTOL),
            "fused and wavefront images differ")

    # --- phase 5: accuracy against the independent numpy oracle ---
    t0 = time.perf_counter()
    e1 = render_mean(scene, cam, 256, 2048, 0, dev)
    e2 = render_mean(scene, cam, 256, 2048, 1 << 16, dev)
    t_render = time.perf_counter() - t0
    o1, o2 = (np.load(ORACLE.format(s))["img"] for s in (11, 12))
    se1, se2, so1, so2 = srgb64(e1), srgb64(e2), srgb64(o1), srgb64(o2)
    prod = (se1 - so1) * (se2 - so2)   # run_rmse_gate.py:133-145
    bias2 = float(prod.mean())
    res2 = float(2.0 * prod.std() / np.sqrt(prod.size))
    rmse = float(np.sqrt(max(0.0, bias2)))
    require(np.isfinite(e1).all() and np.isfinite(e2).all(), "non-finite")
    phase("5 oracle", cornell_rmse_vs_oracle=f"{rmse:.6g}",
          bias_resolution_2sigma=f"{np.sqrt(res2):.6g}",
          spp_per_half=2048, oracle_spp_per_half=928, depth=4,
          render_s=f"{t_render:.2f}")
    require(rmse <= 1e-3, f"cornell_rmse_vs_oracle {rmse} > 1e-3")

    # --- phase 6: the headline launch (main path; launches counted per
    # path: "auto" is the fused kernel, "wavefront" kernels 1-2) ---
    W, H, spl, depth = (HEADLINE[k] for k in ("width", "height", "spl",
                                              "depth"))
    cam = cornell_camera(W, H).params(dev)
    film, rays_f, dt_f, peak_f, first_f, first_rays_f, n_f = timed_launches(
        scene, cam, W, H, spl, depth, "auto", 2, dev)
    _, rays_w, dt_w, peak_w, first_w, first_rays_w, n_w = timed_launches(
        scene, cam, W, H, spl, depth, "wavefront", 1, dev)
    require(n_f["pt_fused_cornell"] > 0,
            "pt_fused_cornell never launched on the Cornell auto path")
    for name in ("bf_closest", "bf_any"):
        require(n_w[name] > 0,
                f"{name} never launched on the Cornell wavefront path")
    launches = dict(pt_fused_cornell=n_f["pt_fused_cornell"],
                    bf_closest=n_w["bf_closest"], bf_any=n_w["bf_any"])
    # kernel 3 vs its plain version at the main path's own shape: the
    # first launch of each path, both from subframe 0
    a, b = to_np(first_f.accum), to_np(first_w.accum)
    require(first_rays_f == first_rays_w,
            f"headline ray counts differ: {first_rays_f} vs {first_rays_w}")
    require(np.allclose(a, b, atol=ATOL, rtol=RTOL),
            f"headline images differ by {np.abs(a - b).max()}")
    head_err = float(np.abs(a - b).max())
    record["pt_fused_cornell"]["max_abs_err"] = max(
        record["pt_fused_cornell"]["max_abs_err"], head_err)
    img = to_np(film.accum)
    require(img.shape == (H, W, 3) and np.isfinite(img).all()
            and img.mean() > 0, "headline image not finite / empty")
    ms_f, ms_w = 1e3 * dt_f / 2, 1e3 * dt_w
    phase("6 headline", card=repr(card), dim=f"{W}x{H}", spl=spl, depth=depth,
          mrays_per_s=f"{rays_f / dt_f / 1e6:.1f}",
          msamples_per_s=f"{2 * W * H * spl / dt_f / 1e6:.1f}",
          rays_per_launch=rays_f // 2, fused_ms_per_launch=f"{ms_f:.2f}",
          wavefront_ms_per_launch=f"{ms_w:.2f}",
          wavefront_mrays_per_s=f"{rays_w / dt_w / 1e6:.1f}",
          peak_mem_mib=f"{peak_f / 2**20:.0f}",
          wavefront_peak_mem_mib=f"{peak_w / 2**20:.0f}",
          image_mean=f"{img.mean():.5f}",
          auto_launches={k: n_f[k] for k in ("bf_closest", "bf_any",
                                             "pt_fused_cornell")},
          wavefront_launches={k: n_w[k] for k in ("bf_closest", "bf_any",
                                                  "pt_fused_cornell")},
          fused_vs_wavefront_max_abs_diff=head_err,
          pixels_bit_equal=f"{np.mean(np.all(a == b, axis=-1)):.6f}")
    record["pt_fused_cornell"].update(ms=ms_f, plain_ms=ms_w)

    # kernels 1 and 2 vs their plain versions on one 2M-ray wavefront
    cam_rays, shadow = camera_and_shadow_rays(scene, W, H, dev)
    tc, tm = scene.geom.tri_consts, scene.tri_mat
    e_head = compare_hits(pallas_bf.closest_hit(tc, tm, cam_rays),
                          pallas_bf.closest_hit_plain(tc, tm, cam_rays),
                          "cornell 1920x1088")
    occ_k = to_np(pallas_bf.any_hit(tc, shadow))
    occ_p = to_np(pallas_bf.any_hit_plain(tc, shadow))
    require(np.array_equal(occ_k, occ_p), "cornell 1920x1088: occlusion")
    record["bf_closest"]["max_abs_err"] = max(
        record["bf_closest"]["max_abs_err"], e_head)
    times = dict(
        bf_closest=(cuda_ms(lambda: pallas_bf.closest_hit(tc, tm, cam_rays), 20),
                    cuda_ms(lambda: pallas_bf.closest_hit_plain(tc, tm,
                                                                cam_rays), 3)),
        bf_any=(cuda_ms(lambda: pallas_bf.any_hit(tc, shadow), 20),
                cuda_ms(lambda: pallas_bf.any_hit_plain(tc, shadow), 3)))
    for name, (k_ms, p_ms) in times.items():
        record[name].update(ms=k_ms, plain_ms=p_ms)
    phase("6 bf timing", rays=W * H,
          **{f"{n}_ms": f"{t[0]:.3f}" for n, t in times.items()},
          **{f"{n}_plain_ms": f"{t[1]:.3f}" for n, t in times.items()})

    # --- phases (a)-(d): the large-mesh path (kernels 4-6) ---
    launches.update(knot_phases(dev, card, record))

    # --- phase 7: the record and the verdict ---
    meta = dict(
        bf_closest=("optix_raytracer_tpu_torch/csrc/bf.cu",
                    "optix_raytracer_tpu/accel/pallas_bf.py:174"),
        bf_any=("optix_raytracer_tpu_torch/csrc/bf.cu",
                "optix_raytracer_tpu/accel/pallas_bf.py:200"),
        pt_fused_cornell=("optix_raytracer_tpu_torch/csrc/pt_fused.cu",
                          "optix_raytracer_tpu/wavefront/pallas_pt.py:1478"),
        cluster_cull_exact=("optix_raytracer_tpu_torch/csrc/clusters.cu",
                            "optix_raytracer_tpu/accel/clusters.py:312"),
        cluster_closest=("optix_raytracer_tpu_torch/csrc/clusters.cu",
                         "optix_raytracer_tpu/accel/clusters.py:1150"),
        cluster_any=("optix_raytracer_tpu_torch/csrc/clusters.cu",
                     "optix_raytracer_tpu/accel/clusters.py:1372"))
    print(json.dumps({"kernels": [
        dict(name=n, route="cuda", source=meta[n][0], replaces=meta[n][1],
             launches=launches[n], **record[n]) for n in meta]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
