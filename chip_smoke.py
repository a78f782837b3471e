#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (optix_raytracer_tpu_torch) on one
CUDA card: builds the hand-written kernels from this checkout, checks each
against its plain PyTorch version, checks the renderer against the JAX
package's engine semantics and the committed numpy-oracle pair, then times
the two main paths: the Cornell headline launch (1920x1088, 16 samples per
launch, depth 4; kernels 1-3) and the large-mesh launch (the 25,202-triangle
trefoil-knot scene, 1920x1088, 16 samples per launch, depth 3; kernels 4-6,
the cluster-culled traversal), whose kernels are also held against their
plain versions on the 25k knot and on a 500k-triangle knot, and the same
launch through the cluster-major queue (ORT_QWALK=1; kernels 7-8, held
against their plain versions and A/B-timed against the walk on the same
sets); then the 4M-triangle knot through the supercluster tier. Between
the Cornell and the knot phases, phases 7-9 hold the fused kernel's
specular, PBR, prim, instance and smooth-normal instantiations (3') against
the wavefront on the bench's prims + glass scene, the PBR Cornell, the
mirror Cornell, the instanced Cornell and a 482-triangle smooth knot, and
time their headline launches (1920x1088, 16 samples per launch, depth 4;
depth 3 on the knot); phases k1-k3 do the same for the texture
instantiations on bench.py's textured scene (its own frame: 1920x1088, 4
samples per launch, depth 3) and two smaller textured variants, and phase l
holds kernel 9, the texture-fetch study's row fetch, to its plain version
and repeats the study's A/B against torch's row gather.

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
# bench.py:361's 4.0M-triangle mesh on the lit knot_scene, at the knot
# headline's frame, spl and depth: the supercluster tier (kernels 5c/6c)
KNOT_SC = dict(segments=1450, sides=1380, width=1920, height=1088, spl=16,
               depth=3)
# List entries (block x cluster pairs, 32,768 ray-triangle tests each) past
# which the plain walks run on a subset of blocks (about 2 s on the card).
PLAIN_WALK_ENTRIES = 200_000
# The same for the plain supercluster walks, counted in member visits
# (block x crossed member cluster).
PLAIN_SC_VISITS = 60_000
# The queue's capacity, work items per octet of the padded batch
# (optix_raytracer_tpu/accel/qwalk.py:307, the default of both packages).
QWALK_QF = 6
# Queue steps (256 marshalled rays x one cluster) past which kernel 8's
# plain version runs on every k-th step only.
PLAIN_QUEUE_STEPS = 4096

# The card's peaks for the bound of each kernel (H100 SXM data sheet, dense,
# at 700 W): FP32 outside the tensor cores, and HBM3.
FP32_PEAK = 67e12
HBM_RATE = 3.35e12
PAIR_OPS = 30      # FP32 operations of one Woop ray-triangle test
SLAB_OPS = 20      # FP32 operations of one ray-box slab test
RAY_BYTES = 32     # ox oy oz dx dy dz tmin tmax
SLOT_BYTES = 4 * 128               # one constant row of a 128-slot cluster
CLOSEST_ROWS, ANY_ROWS = 23, 12    # rows a closest / any-hit walk reads
# FP32 operations of one ray against one custom prim of each kind, counted
# from accel/primitives.py's formulas (per-prim constants left out): sphere,
# shell (two spheres), parallelogram, capsule (body + two cap spheres).
PRIM_OPS = {0: 20, 1: 40, 2: 38, 3: 135}
PRIMS_ATOL = 3e-3                 # tests/test_fused_kernel.py:238
INST_ATOL = 3e-3                  # tests/test_fused_kernel.py:271, 292
# knot_scene(16, 15): 2 * 16 * 15 tube triangles + a 2-triangle floor = 482,
# under the fused kernel's 512 and with no cluster table; at the knot
# headline's depth (bench.py:299-304).
SMOOTH_KNOT = dict(segments=16, sides=15, depth=3)
# FP32 operations of one ray's move into an instance's object space (a 3x4
# point and a 3x3 vector transform) and of a smooth hit's normal
# interpolation (shading_frame: weights, 3 x 3 products and sums, length,
# division).
INST_XF_OPS = 36
SMOOTH_OPS = 25
# bench.py:219-259: the textured scene at its own frame and depth.
TEXTURED = dict(width=1920, height=1088, spl=4, depth=3)
# tests/test_fused_textures.py:29-63's maps (base, normal, mr, emissive).
TEXTURED_SMALL = (32, 16, 16, 8)
# FP32 operations of one textured hit (pt_fused.cuh, kTex), counted from the
# code: uv interpolation and the cone 15, the level 11, two bilinear levels
# of 12 channels (4 taps, 9 operations a channel, and the texel's setup)
# 244, the blend 37, the base, mr and emissive maps 8, the normal map 60.
TEX_OPS = 375


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


def bound(ops, nbytes):
    """The least time the card could take for work of `ops` FP32 operations
    moving `nbytes` bytes: the larger of ops / FP32 peak and bytes / HBM
    rate → dict(bound_ms, bound_by)."""
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_RATE
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def live_rays(packed):
    """Live rays (tmax > tmin) per 32-ray group of packed rays → [n_blocks,
    8] int64."""
    return (packed[:, 7] > packed[:, 6]).reshape(-1, 8, 32).sum(2)


def listed_entries(counts, lists):
    """The valid entries of per-block lists → (blocks [E], box ids [E]),
    each int64; the group bits of an entry are dropped."""
    import torch
    nb = counts.numel()
    lst = lists.reshape(nb, -1)
    valid = (torch.arange(lst.shape[1], device=lst.device)[None]
             < counts.reshape(nb, 1))
    be, ke = torch.nonzero(valid, as_tuple=True)
    return be, (lst[be, ke] & 0xFFFF).to(torch.int64)


def member_visits(counts, lists, member, packed, chunk=4096):
    """Member visits of kernels 5c/6c per block [n_blocks] int64: for each
    listed supercluster, the members that some live ray of the block
    crosses (the block-union mask the kernels and their plain versions
    walk)."""
    import torch
    from optix_raytracer_tpu_torch.accel import clusters as C
    nb = counts.numel()
    rays = packed.reshape(nb, C.SUB, 8)
    be, se = listed_entries(counts, lists)
    visits = torch.zeros(nb, dtype=torch.int64, device=packed.device)
    for i in range(0, be.numel(), chunk):
        b, s = be[i:i + chunk], se[i:i + chunk]
        visits.index_add_(0, b, C._member_cross(rays[b], member[s])
                          .any(dim=1).sum(dim=1))
    return visits


def needed_work(counts, lists, boxes, n_real, packed, end, occluded=0):
    """The least work of a walk over these lists: for each listed entry
    (block b, box s) and each ray of block b, the members of boxes[s]
    ([S, 6, M]: lo xyz, hi xyz of M boxes; member c of s is cluster
    s * M + c, a real one below n_real) that the ray's own slab test
    crosses on [tmin, end]. `end` [n_padded] is the ray's closest hit for a
    closest walk (a walk must open every box the ray enters before it), its
    tmax for an any-hit walk, or its tmin for a ray that needs no walk; each
    of the `occluded` rays adds one pair test, its hit. → dict(entries,
    pairs (ray x crossed member x 128 triangles), slabs (ray x entry x M,
    over the entries where the ray crosses a member), members (distinct
    members crossed), listed (distinct listed boxes))."""
    import torch
    from optix_raytracer_tpu_torch.accel import clusters as C
    nb, m = counts.numel(), boxes.shape[2]
    ends = packed.clone()
    ends[:, 7] = end
    rays = ends.reshape(nb, C.SUB, 8)
    be, se = listed_entries(counts, lists)
    used = torch.zeros((boxes.shape[0], m), dtype=torch.int64,
                       device=packed.device)
    lane = torch.arange(m, device=packed.device)
    pairs = slabs = 0
    chunk = max(1, (1 << 25) // (C.SUB * m))
    for i in range(0, be.numel(), chunk):
        b, s = be[i:i + chunk], se[i:i + chunk]
        real = (s[:, None] * m + lane[None]) < n_real           # [B, M]
        cross = C._member_cross(rays[b], boxes[s]) & real[:, None]
        pairs += int(cross.sum()) * C.LANES
        slabs += int(cross.any(dim=2).sum()) * m
        used.index_put_((s,), cross.any(dim=1).to(torch.int64),
                        accumulate=True)
    return dict(entries=int(be.numel()), pairs=pairs + int(occluded),
                slabs=slabs, members=int((used > 0).sum()),
                listed=int(se.unique().numel()))


def walk_bound(counts, lists, boxes, n_real, packed, out, closest, sc=0):
    """Bound of a walk on all blocks of these lists, from needed_work with
    the walk's own result: out is the closest walk's rows (the hit t ends
    each ray's window) or the any-hit walk's occlusion. The pair tests (and,
    for the supercluster walks, sc > 0, the member slab tests) over the FP32
    peak; the rays, counts, listed entries (id + bound), the listed
    superclusters' member boxes, the crossed members' rows and the output
    over the HBM rate."""
    import torch
    if closest:
        work = needed_work(counts, lists, boxes, n_real, packed, out[:, 0])
    else:
        hit = out != 0
        work = needed_work(counts, lists, boxes, n_real, packed,
                           torch.where(hit, packed[:, 6], packed[:, 7]),
                           occluded=int(hit.sum()))
    n_padded = packed.shape[0]
    rows = CLOSEST_ROWS if closest else ANY_ROWS
    nbytes = (n_padded * (RAY_BYTES + (RAY_BYTES if closest else 4))
              + (n_padded // 256) * 4 + work["entries"] * 8
              + work["listed"] * 6 * sc * 4
              + work["members"] * rows * SLOT_BYTES)
    ops = PAIR_OPS * work["pairs"] + (SLAB_OPS * work["slabs"] if sc else 0)
    return dict(bound(ops, nbytes), pairs=work["pairs"])


def fmt(r):
    """A parity result as phase fields: times to the microsecond, each
    bound as its milliseconds and what bounds it, and a walk's bound its
    needed pair tests."""
    out = {}
    for k, v in r.items():
        if k.endswith("_bound"):
            out[f"{k}_ms"] = f"{v['bound_ms']:.3f}({v['bound_by']})"
            if "pairs" in v:
                out[f"{k}_pairs"] = v["pairs"]
        elif isinstance(v, float) and k.endswith("ms"):
            out[k] = f"{v:.3f}"
        else:
            out[k] = v
    return out


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
    its last; the warm-up's seconds)."""
    import torch
    from optix_raytracer_tpu_torch import kernels
    from optix_raytracer_tpu_torch.core.film import Film
    from optix_raytracer_tpu_torch.wavefront.engine import render_accumulate
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    first, first_rays = render_accumulate(
        scene, cam, Film.create(H, W, dev), W, H, spl, depth, impl=impl)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    film = first
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
            counts, first_s)


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


def cull_parity(cl, packed, what, out):
    """Kernel 4 against its plain version on cl's table (a cluster set, or
    the supercluster facade): tn / gm and the compacted counts / lists /
    bounds bit-equal. Adds its CUDA-event times and bound to `out` and
    returns the kernel's compacted lists."""
    import torch
    from optix_raytracer_tpu_torch.accel import clusters as C
    n_blocks, c_pad = packed.shape[0] // C.SUB, cl.c_pad
    n_super = n_blocks // C.GROUPS
    tn_k, gm_k = C.exact_cull(cl.aabb, packed, n_blocks, c_pad)
    tn_p, gm_p = C.exact_cull_plain(cl.aabb, packed, n_blocks, c_pad)
    require(torch.equal(tn_k.view(torch.int32), tn_p.view(torch.int32))
            and torch.equal(gm_k, gm_p), f"{what}: exact cull differs")
    culled = C._compact(cl, *C._cull_tables(tn_k, gm_k), n_super)
    culled_p = C._compact(cl, *C._cull_tables(tn_p, gm_p), n_super)
    require(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                for a, b in zip(culled, culled_p)),
            f"{what}: counts / lists / bounds differ")
    live = int(live_rays(packed).sum())
    out.update(
        cull_ms=cuda_ms(lambda: C.exact_cull(cl.aabb, packed, n_blocks,
                                             c_pad), 10),
        cull_plain_ms=cuda_ms(lambda: C.exact_cull_plain(
            cl.aabb, packed, n_blocks, c_pad), 1),
        cull_bound=bound(SLAB_OPS * live * cl.num_clusters,
                         packed.shape[0] * RAY_BYTES + c_pad * 24
                         + n_blocks * c_pad * 8))
    return culled


def block_subset(weights, budget, *tensors):
    """Every k-th block of the [n_blocks, ...] tensors, k chosen so the
    subset's weights (list entries, member visits) sum to about `budget` →
    (blocks or None when all fit, the tensors cut to them)."""
    import torch
    stride = max(1, -(-int(weights.sum()) // budget))
    if stride == 1:
        return None, tensors
    blocks = torch.arange(0, weights.shape[0], stride, device=weights.device)
    return blocks, tuple(t[blocks].contiguous() for t in tensors)


def cluster_parity(cl, rays, exact, gate, what):
    """Kernels 4-6 against their plain versions on one ray set: the exact
    cull's tn / gm and the compacted counts / lists / bounds bit-equal, the
    walks' hits within compare_hits and their occlusion equal. Returns the
    errors, the kernels' CUDA-event times and bounds on all blocks, and the
    plain versions' times.

    The plain walks test every listed (ray block, cluster) pair with torch
    ops; past PLAIN_WALK_ENTRIES list entries both walks are compared, and
    the plain ones timed, on every k-th block only (`walk_blocks` says how
    many; the kernels' times there are `*_subset_ms`)."""
    import torch
    from optix_raytracer_tpu_torch.accel import clusters as C
    n = rays.tmin.shape[0]
    n_padded = C._padded(n)
    packed = C._pack_rays(rays, n_padded)
    n_blocks, n_super, c_pad = n_padded // C.SUB, n_padded // C.SUPER, cl.c_pad
    out = dict(cull_err=0.0)
    if exact and c_pad <= C.MAX_CLUSTERS:
        culled = cull_parity(cl, packed, what, out)
    else:
        culled = C._cull(cl, packed, n_super, c_pad, exact=exact)
    counts, lists, tnear = (t.reshape(n_blocks, -1) for t in culled)
    full = (counts, lists, tnear, cl.comp, packed)
    blocks, (pc, pl, pt, pp) = block_subset(
        counts, PLAIN_WALK_ENTRIES, counts, lists, tnear,
        packed.reshape(n_blocks, C.SUB, 8))
    part = (pc, pl, pt, cl.comp, pp.reshape(-1, 8))
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
    out["mean_clusters_per_block"] = int(counts.sum()) / n_blocks
    out["walk_blocks"] = (f"{part[0].shape[0]} of {n_blocks}"
                          if blocks is not None else "all")
    boxes = C._aabb_rows(cl)[:, :, None]                     # [c_pad, 6, 1]
    out.update(
        closest_ms=cuda_ms(lambda: C.walk_closest(*full, gate), 10),
        closest_plain_ms=cuda_ms(lambda: C.walk_closest_plain(*part, gate),
                                 1),
        any_ms=cuda_ms(lambda: C.walk_any(*full, gate), 10),
        any_plain_ms=cuda_ms(lambda: C.walk_any_plain(*part, gate), 1),
        closest_bound=walk_bound(counts, lists, boxes, cl.num_clusters,
                                 packed, C.walk_closest(*full, gate), True),
        any_bound=walk_bound(counts, lists, boxes, cl.num_clusters, packed,
                             C.walk_any(*full, gate), False))
    if blocks is not None:
        out.update(
            closest_subset_ms=cuda_ms(lambda: C.walk_closest(*part, gate), 10),
            any_subset_ms=cuda_ms(lambda: C.walk_any(*part, gate), 10))
    return out


def sc_parity(cl, rays, exact, what, timed):
    """Kernels 5c and 6c (and kernel 4 on the supercluster facade, where the
    cull is exact) against their plain versions on one ray set: cull tables
    and lists bit-equal, 5c's rows bit-equal, 6c's occlusion equal. Both
    walks are compared; the `timed` one ("closest" or "any") is timed on all
    blocks (mean of 10) and, plain, on the compared blocks, and its bound
    counted on all blocks (walk_bound). Past PLAIN_SC_VISITS member visits
    the comparison runs on every k-th block. closest_err is the max abs
    difference of the rows, any_mismatches the differing occlusion flags."""
    import torch
    from optix_raytracer_tpu_torch.accel import clusters as C
    n = rays.tmin.shape[0]
    n_padded = C._padded(n)
    packed = C._pack_rays(rays, n_padded)
    n_blocks, n_super = n_padded // C.SUB, n_padded // C.SUPER
    cull_aabb, member, n_sc = C._sc_tables(cl)
    facade = C._sc_facade(cl, cull_aabb, n_sc)
    out = dict(cull_err=0.0)
    if exact:
        culled = cull_parity(facade, packed, what, out)
    else:
        culled = C._cull(facade, packed, n_super, facade.c_pad, exact=False)
    counts, lists, tnear = (t.reshape(n_blocks, -1) for t in culled)
    visits = member_visits(counts, lists, member, packed)
    blocks, (pc, pl, pt, pp) = block_subset(
        visits, PLAIN_SC_VISITS, counts, lists, tnear,
        packed.reshape(n_blocks, C.SUB, 8))
    full = (counts, lists, tnear, cl.comp, member, packed)
    part = (pc, pl, pt, cl.comp, member, pp.reshape(-1, 8))
    rows_k = C.walk_sc_closest(*part)
    rows_p = C.walk_sc_closest_plain(*part)
    out["closest_err"] = float(torch.where(
        rows_k == rows_p, 0.0, (rows_k - rows_p).abs()).max())
    require(torch.equal(rows_k.view(torch.int32), rows_p.view(torch.int32)),
            f"{what}: sc closest rows differ from the plain version "
            f"(max abs err {out['closest_err']})")
    live = torch.repeat_interleave(pc.reshape(-1) > 0, C.SUB)
    hits = C._hits_from_rows(rows_k, live, part[5][:, 7])
    occ_k, occ_p = C.walk_sc_any(*part), C.walk_sc_any_plain(*part)
    out["any_mismatches"] = int((occ_k != occ_p).sum())
    require(out["any_mismatches"] == 0, f"{what}: sc occlusion differs")
    closest = timed == "closest"
    walk = C.walk_sc_closest if closest else C.walk_sc_any
    plain = C.walk_sc_closest_plain if closest else C.walk_sc_any_plain
    entries = int(counts.sum())
    out.update(
        rows_bit_equal=True,
        compared_hits=int((hits.prim_id >= 0).sum()),
        compared_occluded=int(occ_k.sum()),
        entries_per_block=entries / n_blocks,
        members_per_entry=int(visits.sum()) / max(entries, 1),
        member_visits=int(visits.sum()),
        walk_blocks=(f"{pc.shape[0]} of {n_blocks}" if blocks is not None
                     else "all"),
        **{f"{timed}_ms": cuda_ms(lambda: walk(*full), 10),
           f"{timed}_plain_ms": cuda_ms(lambda: plain(*part), 1),
           f"{timed}_bound": walk_bound(counts, lists, member,
                                        cl.num_clusters, packed, walk(*full),
                                        closest, sc=member.shape[2])})
    return out


def prim_clusters(cl):
    """The cluster of each triangle id in cl's table → [max id + 1] int64
    (-1 for an id that no slot holds)."""
    import torch
    from optix_raytracer_tpu_torch.accel import clusters as C
    sp = cl.slot_prim.to(torch.int64)
    valid = sp >= 0
    out = torch.full((int(sp.max()) + 1,), -1, dtype=torch.int64,
                     device=sp.device)
    out[sp[valid]] = torch.nonzero(valid)[:, 0] // C.LANES
    return out


def queue_vs_walk(q, w, p2c, what):
    """The queue's closest hits q against the walk's w on one set: prim and
    material ids equal, and t, uv and normals within compare_hits' bars,
    except where both hit at the same t, bit for bit, in two clusters: an
    exact cross-cluster tie, which the queue gives to the lower cluster id
    and the walk to the cluster it enters first → the count of such ties."""
    import torch
    diff = (q.prim_id != w.prim_id) | (q.mat_id != w.mat_id)
    qp, wp = q.prim_id[diff], w.prim_id[diff]
    tie = ((qp >= 0) & (wp >= 0)
           & (q.t[diff].view(torch.int32) == w.t[diff].view(torch.int32))
           & (p2c[qp.clamp_min(0)] != p2c[wp.clamp_min(0)]))
    require(bool(tie.all()),
            f"{what}: {int((~tie).sum())} hits differ from the gated walk's "
            f"other than by an exact cross-cluster tie")
    hit = (w.prim_id >= 0) & ~diff
    for k, tol in (("t", dict(rtol=1e-5, atol=0)),
                   ("uv", dict(rtol=0, atol=1e-4)),
                   ("normal", dict(rtol=0, atol=1e-5))):
        require(np.allclose(to_np(getattr(q, k)[hit]),
                            to_np(getattr(w, k)[hit]), **tol),
                f"{what}: {k} of the queue's hits outside {tol}")
    return int(diff.sum())


def queue_parity(cl, rays, closest, gate, what, queue_bound, p2c):
    """Kernels 7 and 8 of the queue (accel/qwalk.py) on one ray set, and the
    queue's A/B against the walk the engine takes there (exact cull, gated
    when `gate`).

    Kernel 7's masks equal its plain version's. The queue is built at
    QWALK_QF, as a query builds it (n_items, k_cap, overflow), and again at
    the least qf that holds the whole list (qf_fit; the same list when it
    does not overflow), on which kernel 8 runs: its candidate columns
    bit-equal to the plain version's on every k-th step (PLAIN_QUEUE_STEPS)
    and to its own run over all steps. The query's hits (at qf_fit and at
    QWALK_QF, which overflows to the walk) equal the walk's, or differ by
    exact ties (queue_vs_walk); occlusion equal.

    Times (CUDA events, mean of 10; plain versions one call): kernel 7,
    kernel 8 on all steps, the whole query at qf_fit and the walk's whole
    query; build_marshal_reduce_ms is the query's rest (packing, work-list
    build, marshalling, per-ray reduction). `queue_bound` is the walk's
    bound on this set (walk_bound): kernel 8 answers the same query."""
    import torch
    from optix_raytracer_tpu_torch.accel import clusters as C
    from optix_raytracer_tpu_torch.accel import qwalk as Q
    n, n_padded, packed, n_blocks, c_pad, k_cap = Q._prep(cl, rays, QWALK_QF)
    om = Q._oct_cull(cl, packed, n_blocks, c_pad)
    om_p = Q.oct_cull_plain(cl.aabb, packed, n_blocks, c_pad)
    out = dict(oct_mismatches=int((om != om_p).sum()))
    require(out["oct_mismatches"] == 0,
            f"{what}: octet masks differ from the plain version")
    _, _, overflow, n_items = Q._build_queue(om, cl.num_clusters, n_padded,
                                             k_cap)
    require(n_items > 0, f"{what}: empty work list")
    n_oct = n_padded // Q.OCT
    qf_fit = max(QWALK_QF, -(-n_items // n_oct))
    k_fit = max(Q.ITEMS, (qf_fit * n_oct // Q.ITEMS) * Q.ITEMS)
    steps, work, over_fit, _ = Q._build_queue(om, cl.num_clusters, n_padded,
                                              k_fit)
    require(not over_fit, f"{what}: qf {qf_fit} does not hold the list")
    qrays, _ = Q._marshal(packed, work[:n_items], n_padded)
    live = steps[:, :n_items // Q.ITEMS].contiguous()
    n_steps = live.shape[1]
    stride = max(1, -(-n_steps // PLAIN_QUEUE_STEPS))
    idx = torch.arange(0, n_steps, stride, device=live.device)
    sub = live[:, idx].clone()                 # own output columns 0..S-1
    sub[1] = torch.arange(idx.numel(), dtype=torch.int32, device=idx.device)
    plain = Q.queue_closest_plain if closest else Q.queue_any_plain
    sub_k = Q._run_queue(closest, cl.comp, sub, qrays)
    sub_p = plain(sub, qrays, cl.comp)
    full_k = Q._run_queue(closest, cl.comp, live, qrays)
    lane = torch.arange(Q.ROWS, device=idx.device)
    cols = (idx[:, None] * Q.ROWS + lane[None]).reshape(-1)
    out["queue_err"] = float(torch.where(sub_k == sub_p, 0.0,
                                         (sub_k - sub_p).abs()).max())
    require(torch.equal(sub_k.view(torch.int32), sub_p.view(torch.int32)),
            f"{what}: kernel 8 differs from its plain version (max abs err "
            f"{out['queue_err']})")
    require(torch.equal(full_k[:, cols].view(torch.int32),
                        sub_k.view(torch.int32)),
            f"{what}: kernel 8 on all steps differs from its run on the "
            f"compared steps")
    del sub_k, sub_p, full_k

    query = Q.closest_hit if closest else Q.any_hit
    walk = C.closest_hit if closest else C.any_hit
    w = walk(cl, rays, exact=True, group_walk=gate)
    q_fit, q6 = query(cl, rays, qf=qf_fit), query(cl, rays, qf=QWALK_QF)
    if closest:
        out["ties"] = queue_vs_walk(q_fit, w, p2c, what)
        out["ties_qf6"] = queue_vs_walk(q6, w, p2c, what)
        out["hits"] = int((w.prim_id >= 0).sum())
    else:
        out["any_mismatches"] = int((q_fit != w).sum() + (q6 != w).sum())
        require(out["any_mismatches"] == 0,
                f"{what}: the queue's occlusion differs from the walk's")
        out["occluded"] = int(w.sum())
    del q_fit, q6, w
    live_n = int((rays.tmax > rays.tmin).sum())
    out.update(
        n_items=n_items, k_cap=k_cap, overflow=bool(overflow), qf_fit=qf_fit,
        items_per_live_octet=n_items / max(live_n / Q.OCT, 1.0),
        live_rays=live_n, steps=n_steps,
        plain_steps=(f"{idx.numel()} of {n_steps}" if stride > 1 else "all"),
        oct_ms=cuda_ms(lambda: Q._oct_cull(cl, packed, n_blocks, c_pad), 10),
        oct_plain_ms=cuda_ms(lambda: Q.oct_cull_plain(cl.aabb, packed,
                                                      n_blocks, c_pad), 1),
        queue_ms=cuda_ms(lambda: Q._run_queue(closest, cl.comp, live, qrays),
                         10),
        queue_plain_ms=cuda_ms(lambda: plain(sub, qrays, cl.comp), 1),
        queue_subset_ms=cuda_ms(lambda: Q._run_queue(closest, cl.comp, sub,
                                                     qrays), 10),
        query_ms=cuda_ms(lambda: query(cl, rays, qf=qf_fit), 10),
        walk_query_ms=cuda_ms(lambda: walk(cl, rays, exact=True,
                                           group_walk=gate), 10),
        oct_bound=bound(SLAB_OPS * live_n * cl.num_clusters,
                        n_padded * RAY_BYTES + c_pad * 24
                        + n_blocks * c_pad * 4),
        queue_bound=queue_bound)
    out["build_marshal_reduce_ms"] = (out["query_ms"] - out["oct_ms"]
                                      - out["queue_ms"])
    if overflow:      # the query as the engine runs it: cull, then the walk
        out["query_qf6_ms"] = cuda_ms(lambda: query(cl, rays), 10)
    return out


def qwalk_parity_phases(cl, big, sets, big_shadow, res, record):
    """Phases (h) and (i): queue_parity on the 25k knot's sets (`sets`:
    name → (rays, closest, gated), res's walk bounds under the same name)
    and on the 500k knot's NEE set (the streaming tier, past
    MAX_CLUSTERS). Fills the JSON record of kernels 7-8 from the strip's
    bounce-1 queries."""
    p2c = prim_clusters(cl)
    qres = {}
    for name, (rays, closest, gate) in sets.items():
        kind = "closest" if closest else "any"
        qres[name] = r = queue_parity(cl, rays, closest, gate,
                                      f"knot25k {name} queue",
                                      res[name][f"{kind}_bound"], p2c)
        phase(f"h knot25k {name}", rays=rays.tmin.shape[0], query=kind,
              gated_walk=gate, **fmt(r))
    r = queue_parity(big, big_shadow, False, False, "knot500k shadow queue",
                     res["knot500k_shadow"]["any_bound"], prim_clusters(big))
    phase("i knot500k shadow", rays=big_shadow.tmin.shape[0], query="any",
          clusters=big.num_clusters, **fmt(r))
    b1, b1s = qres["strip_bounce1"], qres["strip_bounce1_shadow"]
    every = list(qres.values()) + [r]
    record["qwalk_oct_cull"] = dict(
        max_abs_err=float(max(x["oct_mismatches"] for x in every)),
        ms=b1["oct_ms"], plain_ms=b1["oct_plain_ms"], **b1["oct_bound"],
        plain_blocks="all")
    for name, src in (("qwalk_closest", b1), ("qwalk_any", b1s)):
        record[name] = dict(
            max_abs_err=max(x["queue_err"] for x in every),
            ms=src["queue_ms"], plain_ms=src["queue_plain_ms"],
            **src["queue_bound"], plain_blocks=f"steps {src['plain_steps']}")


def qwalk_headline(scene, cam, W, H, spl, depth, dev, card, ref_img,
                   ref_rays):
    """Phase (j): the knot headline under ORT_QWALK=1, sample-major (2
    timed launches) and sequential (1), launches and queue queries counted
    per path. The first launch's ray count equals phase (d)'s and its image
    agrees within the bars; kernel 7 launches on both paths. Returns the
    sample-major path's counts of kernels 7-8."""
    from optix_raytracer_tpu_torch.accel import qwalk as Q
    names = ("qwalk_oct_cull", "qwalk_closest", "qwalk_any",
             "cluster_cull_exact", "cluster_closest", "cluster_any")
    prev = os.environ.get("ORT_QWALK")
    os.environ["ORT_QWALK"] = "1"
    try:
        counts = {}
        for impl, launches in (("auto", 2), ("wavefront", 1)):
            Q.reset_stats()
            film, rays, dt, peak, first, first_rays, n, _ = timed_launches(
                scene, cam, W, H, spl, depth, impl, launches, dev)
            stats = dict(Q.STATS)
            counts[impl] = n
            a = to_np(first.accum)
            require(first_rays == ref_rays,
                    f"queue {impl}: first-launch rays {first_rays} against "
                    f"{ref_rays} through the walk")
            require(np.allclose(a, ref_img, atol=ATOL, rtol=RTOL),
                    f"queue {impl}: image differs from the walk's by "
                    f"{np.abs(a - ref_img).max()}")
            img = to_np(film.accum)
            require(np.isfinite(img).all() and img.mean() > 0,
                    f"queue {impl}: image not finite / empty")
            require(n["qwalk_oct_cull"] > 0,
                    f"qwalk_oct_cull never launched on the queue's {impl} "
                    f"path")
            notes = {}
            for kind in ("closest", "any"):
                require((n[f"qwalk_{kind}"] > 0) == (stats[f"{kind}_queue"]
                                                     > 0),
                        f"queue {impl}: qwalk_{kind} launches do not follow "
                        f"the queries the queue answered")
                if stats[f"{kind}_queue"] == 0:
                    notes[f"{kind}_note"] = (
                        f"every {kind} query overflowed at qf {QWALK_QF}: "
                        f"kernel 8's parity rests on phase h")
            phase(f"j knot headline queue {impl}", card=repr(card),
                  dim=f"{W}x{H}", spl=spl, depth=depth,
                  ms_per_launch=f"{1e3 * dt / launches:.2f}",
                  mrays_per_s=f"{rays / dt / 1e6:.1f}",
                  msamples_per_s=f"{launches * W * H * spl / dt / 1e6:.1f}",
                  rays_per_launch=rays // launches,
                  peak_mem_mib=f"{peak / 2**20:.0f}",
                  first_launch_rays=first_rays,
                  vs_walk_max_abs_diff=float(np.abs(a - ref_img).max()),
                  pixels_bit_equal=(
                      f"{np.mean(np.all(a == ref_img, axis=-1)):.6f}"),
                  queue_queries=stats, launches={k: n[k] for k in names},
                  **notes)
    finally:
        if prev is None:
            os.environ.pop("ORT_QWALK", None)
        else:
            os.environ["ORT_QWALK"] = prev
    return {k: counts["auto"][k] for k in names[:3]}


def knot_phases(dev, card, record):
    """Phases (a)-(d) and (h)-(j): the knot build, kernels 4-6 against their
    plain versions on the 25k knot (probe sets and the main path's own strip
    queries) and the 500k knot, the queue (kernels 7-8) on the same sets
    (h, i; run before d, while the sets are alive), the knot headline
    launch (sample-major against the sequential oracle) with its launches
    counted per path, and the same launch through the queue (j). Returns
    the launch counts of the sample-major (auto) paths."""
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
    prim, shadow, bounce1 = knot_ray_sets(scene, W, H, dev)
    sets = (("primary", prim, False, False), ("shadow", shadow, True, False),
            ("bounce1", bounce1, True, False),
            ("bounce1_gated", bounce1, True, True))
    res = {}
    for name, rays, exact, gate in sets:
        res[name] = r = cluster_parity(cl, rays, exact, gate,
                                       f"knot25k {name}")
        phase(f"b knot25k {name}", rays=W * H, exact=exact, gated=gate,
              **fmt(r))
    stats = C.traversal_stats(cl, prim)
    del prim

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
                  gated=gate, **fmt(r))
    # kernel times of the JSON record: the strip's bounce-1 queries (the
    # kernels on all blocks; the plain walks on the blocks `walk_blocks`
    # names)
    b1, b1s = res["strip_bounce1"], res["strip_bounce1_shadow"]
    record["cluster_cull_exact"] = dict(
        max_abs_err=max(r["cull_err"] for r in res.values()),
        ms=b1["cull_ms"], plain_ms=b1["cull_plain_ms"], **b1["cull_bound"],
        plain_blocks="all")
    record["cluster_closest"] = dict(
        max_abs_err=max(r["closest_err"] for r in res.values()),
        ms=b1["closest_ms"], plain_ms=b1["closest_plain_ms"],
        **b1["closest_bound"], plain_blocks=b1["walk_blocks"])
    record["cluster_any"] = dict(
        max_abs_err=float(max(r["any_mismatches"] for r in res.values())),
        ms=b1s["any_ms"], plain_ms=b1s["any_plain_ms"], **b1s["any_bound"],
        plain_blocks=b1s["walk_blocks"])

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
        res[f"knot500k_{name}"] = r = cluster_parity(big, rays, exact, False,
                                                     f"knot500k {name}")
        record["cluster_closest"]["max_abs_err"] = max(
            record["cluster_closest"]["max_abs_err"], r["closest_err"])
        record["cluster_any"]["max_abs_err"] = max(
            record["cluster_any"]["max_abs_err"], float(r["any_mismatches"]))
        phase(f"c knot500k {name}", rays=W * H, exact_requested=exact,
              **fmt(r))

    # --- (h), (i): the queue (kernels 7-8) on the probe sets, the strip's
    # five queries it answers under ORT_QWALK=1 (recorded above with the
    # walk: with equal hits the rays are the same) and a 500k NEE set ---
    qsets = dict(bounce1=(bounce1, True, True), shadow=(shadow, False, True))
    for b, ((rc, _, _), (ra, _, ga)) in enumerate(zip(closest_calls,
                                                      any_calls)):
        if b > 0:
            qsets[f"strip_bounce{b}"] = (rc, True, True)
        qsets[f"strip_bounce{b}_shadow"] = (ra, False, ga)
    qwalk_parity_phases(cl, big, qsets, bshadow, res, record)
    del big, geom, bprim, bshadow, bounce1, shadow, qsets
    del closest_calls, any_calls, rc, ra, rays
    torch.cuda.empty_cache()

    # --- (d) the knot headline: sample-major vs the sequential oracle,
    # launches counted per path ---
    film, rays_a, dt_a, peak_a, first_a, first_rays_a, n_a, _ = (
        timed_launches(scene, cam, W, H, spl, depth, "auto", 2, dev))
    _, rays_w, dt_w, peak_w, first_w, first_rays_w, n_w, _ = (
        timed_launches(scene, cam, W, H, spl, depth, "wavefront", 1, dev))
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

    # --- (j) the knot headline through the queue ---
    queue_launches = qwalk_headline(scene, cam, W, H, spl, depth, dev, card,
                                    a, first_rays_a)
    return {**{k: n_a[k] for k in names}, **queue_launches}


def sc_phases(dev, card, record):
    """Phases (e)-(g): the 4.0M-triangle knot through the supercluster tier.
    (e) the build, timed per step, and traversal_stats at supercluster
    granularity; (f) kernels 5c/6c (and kernel 4 on the supercluster facade)
    against their plain versions on tile-ordered primaries (interval cull),
    NEE shadow rays (exact cull) and the six cluster queries of one
    sample-major strip of the main path, plus the primaries' closest-hit
    query rate (bench.py:346-384); (g) the 4M launch, sample-major against
    the sequential oracle, launches counted per path. Returns the
    sample-major path's counts of kernels 5c/6c."""
    import torch
    from optix_raytracer_tpu_torch.accel import clusters as C
    from optix_raytracer_tpu_torch.accel import native
    from optix_raytracer_tpu_torch.scene.builtins import (knot_camera,
                                                         knot_scene,
                                                         trefoil_mesh)

    def timed(fn, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # --- (e) the 4M build: the scene, then its three steps again on their
    # own (mesh, SAH order on the scene's geometry, table) ---
    scene, build_s = timed(knot_scene, KNOT_SC["segments"], KNOT_SC["sides"],
                           device=dev)
    cl = scene.clusters
    require(native.available(), "no SAH builder: the 4M knot took morton")
    require(cl.num_clusters > C.MAX_STREAM_CLUSTERS,
            "the 4M knot is not on the supercluster tier")
    _, mesh_s = timed(trefoil_mesh, KNOT_SC["segments"], KNOT_SC["sides"])
    order, sah_s = timed(native.sah_leaf_order, scene.geom)
    again, table_s = timed(C.build_clusters, scene.geom, scene.tri_mat,
                           order=order)
    require(torch.equal(again.comp.view(torch.int32),
                        cl.comp.view(torch.int32)),
            "the 4M table differs between two builds")
    del order, again
    cull_aabb, member, n_sc = C._sc_tables(cl)
    W, H, spl, depth = (KNOT_SC[k] for k in ("width", "height", "spl",
                                              "depth"))
    prim, shadow, _ = knot_ray_sets(scene, W, H, dev)
    stats = C.traversal_stats(cl, prim)
    phase("e knot4m build", triangles=scene.num_triangles,
          clusters=cl.num_clusters, cluster_rows=cl.comp.shape[0],
          superclusters=n_sc, c_pad=cull_aabb.shape[0] * C.LANES,
          comp_mib=f"{cl.comp.numel() * 4 / 2**20:.1f}",
          mesh_s=f"{mesh_s:.2f}", sah_s=f"{sah_s:.2f}",
          table_s=f"{table_s:.2f}", build_s=f"{build_s:.2f}",
          **{k: f"{v:.4g}" for k, v in stats.items()})
    del cull_aabb, member

    # --- (f) kernels 5c / 6c against their plain versions ---
    res = {}
    for name, rays, exact, timed in (("primary", prim, False, "closest"),
                                     ("shadow", shadow, True, "any")):
        res[name] = r = sc_parity(cl, rays, exact, f"knot4m {name}", timed)
        phase(f"f knot4m {name}", rays=W * H, exact=exact, **fmt(r))
    query_ms = cuda_ms(lambda: C.closest_hit(cl, prim), 10)
    phase("f knot4m primaries closest_hit", rays=W * H,
          query_ms=f"{query_ms:.3f}",
          closest_mrays_per_s=f"{W * H / query_ms / 1e3:.1f}")
    del prim, shadow
    cam = knot_camera(W, H).params(dev)
    closest_calls, any_calls = main_path_strip_sets(scene, cam, W, H, spl,
                                                    depth)
    for bounce, ((rc, ec, _), (ra, ea, _)) in enumerate(
            zip(closest_calls, any_calls)):
        require(ec == (bounce > 0) and ea,
                f"4M strip bounce {bounce}: unexpected cull flags")
        for name, rays, exact, timed in (
                (f"strip_bounce{bounce}", rc, ec, "closest"),
                (f"strip_bounce{bounce}_shadow", ra, ea, "any")):
            res[name] = r = sc_parity(cl, rays, exact, f"knot4m {name}",
                                      timed)
            phase(f"f knot4m {name}", rays=rays.tmin.shape[0], exact=exact,
                  **fmt(r))
    del closest_calls, any_calls, rc, ra, rays
    b1, b1s = res["strip_bounce1"], res["strip_bounce1_shadow"]
    record["cluster_sc_closest"] = dict(
        max_abs_err=max(r["closest_err"] for r in res.values()),
        ms=b1["closest_ms"], plain_ms=b1["closest_plain_ms"],
        **b1["closest_bound"], plain_blocks=b1["walk_blocks"])
    record["cluster_sc_any"] = dict(
        max_abs_err=float(max(r["any_mismatches"] for r in res.values())),
        ms=b1s["any_ms"], plain_ms=b1s["any_plain_ms"], **b1s["any_bound"],
        plain_blocks=b1s["walk_blocks"])

    # --- (g) the 4M launch: sample-major against the sequential oracle ---
    film, rays_a, dt_a, peak_a, first_a, first_rays_a, n_a, first_s = (
        timed_launches(scene, cam, W, H, spl, depth, "auto", 2, dev))
    img = to_np(film.accum)
    require(img.shape == (H, W, 3) and np.isfinite(img).all()
            and img.mean() > 0, "4M image not finite / empty")
    _, rays_w, dt_w, peak_w, first_w, first_rays_w, n_w, first_w_s = (
        timed_launches(scene, cam, W, H, spl, depth, "wavefront", 1, dev))
    names = ("cluster_cull_exact", "cluster_sc_closest", "cluster_sc_any")
    for name in names:
        require(n_a[name] > 0, f"{name} never launched on the 4M knot's "
                               f"sample-major (auto) path")
        require(n_w[name] > 0, f"{name} never launched on the 4M knot's "
                               f"sequential (wavefront) path")
    a, b = to_np(first_a.accum), to_np(first_w.accum)
    require(first_rays_a == first_rays_w,
            f"4M ray counts differ: {first_rays_a} vs {first_rays_w}")
    require(np.allclose(a, b, atol=ATOL, rtol=RTOL),
            f"4M images differ by {np.abs(a - b).max()}")
    phase("g knot4m headline", card=repr(card), dim=f"{W}x{H}", spl=spl,
          depth=depth, triangles=scene.num_triangles,
          first_launch_s=f"{first_s:.2f}",
          ms_per_launch=f"{1e3 * dt_a / 2:.2f}",
          mrays_per_s=f"{rays_a / dt_a / 1e6:.2f}",
          msamples_per_s=f"{2 * W * H * spl / dt_a / 1e6:.2f}",
          rays_per_launch=rays_a // 2, peak_mem_mib=f"{peak_a / 2**20:.0f}",
          wavefront_first_launch_s=f"{first_w_s:.2f}",
          wavefront_ms_per_launch=f"{1e3 * dt_w:.2f}",
          wavefront_mrays_per_s=f"{rays_w / dt_w / 1e6:.2f}",
          wavefront_peak_mem_mib=f"{peak_w / 2**20:.0f}",
          first_launch_rays=first_rays_a,
          auto_vs_wavefront_max_abs_diff=float(np.abs(a - b).max()),
          pixels_bit_equal=f"{np.mean(np.all(a == b, axis=-1)):.6f}",
          image_mean=f"{img.mean():.5f}",
          auto_launches={k: n_a[k] for k in names},
          wavefront_launches={k: n_w[k] for k in names})
    return {k: n_a[k] for k in ("cluster_sc_closest", "cluster_sc_any")}


def variant_phases(dev, card, record):
    """Phases 7-9: the fused kernel's instantiations 3' against their plain
    version, on (i) bench.py:153-202's whitted_prims (2 triangles, 4 prims,
    a glass shell), (ii) bench.py:418-450's PBR Cornell (metallic 0.8,
    roughness 0.35), (iii) the Cornell box with mirror white surfaces
    (metallic 1.0, roughness 0.02), (iv) bench.py:387-415's instanced
    Cornell (22 shared triangles in 3 instances, ranges summing to 32) and
    (v) the smooth knot_scene(16, 15) (482 triangles, interpolated normals).
    (7) render_sum_fused against render_sum_plain at 64², spl 2, depth 3:
    ray counts equal, radiance within the bars, two row tiles (by y0) equal
    to the full frame; (8) render_accumulate, fused against wavefront,
    256², spl 4, depth 4 on (i), (ii), (iv) and (v); (9) the headline launch
    of each scene (1920x1088, spl 16, depth 4; 3 on the knot): "auto" (must
    be the fused kernel alone: its LAUNCHES key counts, bf_closest does not)
    for 2 timed launches against "wavefront" (kernels 1-2, once per instance
    per query, + torch prims and shading) for 1, launches counted per path.
    Fills the kernels' record and returns the headlines' launch counts."""
    import torch
    from optix_raytracer_tpu_torch import kernels
    from optix_raytracer_tpu_torch.core.film import Film
    from optix_raytracer_tpu_torch.scene import builtins as B
    from optix_raytracer_tpu_torch.wavefront import pallas_pt
    from optix_raytracer_tpu_torch.wavefront.engine import (_use_fused,
                                                            render_accumulate)
    scenes = {}     # name → (scene, camera, instantiation, atol, depth)
    for name, scene, camera, atol, depth in (
            ("prims", B.prims_scene(dev), B.prims_camera, PRIMS_ATOL,
             HEADLINE["depth"]),
            ("pbr", B.pbr_cornell(dev), B.cornell_camera, ATOL,
             HEADLINE["depth"]),
            ("mirror", B.pbr_cornell(dev, 1.0, 0.02), B.cornell_camera,
             ATOL, HEADLINE["depth"]),
            ("instanced", B.cornell_box_instanced(dev), B.cornell_camera,
             INST_ATOL, HEADLINE["depth"]),
            ("smooth_knot", B.knot_scene(SMOOTH_KNOT["segments"],
                                         SMOOTH_KNOT["sides"], device=dev),
             B.knot_camera, ATOL, SMOOTH_KNOT["depth"])):
        kname = kernels.pt_fused_name(*pallas_pt.fused_variant(scene))
        scenes[name] = (scene, camera, kname, atol, depth)
    inst, knot = scenes["instanced"][0], scenes["smooth_knot"][0]
    require(scenes["instanced"][2] == "pt_fused_inst"
            and inst.instances.num == 3 and sum(
                hi - lo for lo, hi in inst.instances.prim_ranges) == 32,
            "instanced Cornell: not 3 instances over 32 triangles")
    require(scenes["smooth_knot"][2] == "pt_fused_smooth"
            and knot.num_triangles == 482 and knot.geom.smooth
            and not knot.has_clusters,
            f"smooth knot: {knot.num_triangles} triangles, not 482 smooth "
            f"without a cluster table")
    # --- phase 7: each instantiation vs its plain version, 64², spl 2 ---
    w = h = 64
    sub = torch.tensor(5, dtype=torch.int64, device=dev)
    for name, (scene, camera, kname, atol, _) in scenes.items():
        require(_use_fused(scene, "auto"), f"{name}: auto does not take the "
                                           f"fused kernel")
        cam = camera(w, h).params(dev)
        out, c_k = pallas_pt.render_sum_fused(scene, cam, w, h, sub,
                                              samples_per_launch=2,
                                              max_depth=3)
        ref, c_p = pallas_pt.render_sum_plain(scene, cam, w, h, sub,
                                              samples_per_launch=2,
                                              max_depth=3)
        out, ref = to_np(out), to_np(ref)
        require(int(c_k) == int(c_p),
                f"{name}: ray counts {int(c_k)} != {int(c_p)}")
        require(np.allclose(out, ref, atol=atol, rtol=RTOL),
                f"{name}: radiance off by {np.abs(out - ref).max()}")
        halves = [to_np(pallas_pt.render_sum_fused(
            scene, cam, w, h // 2, sub, samples_per_launch=2, max_depth=3,
            y0=y0, full_width=w, full_height=h)[0]) for y0 in (0, h // 2)]
        require(np.array_equal(np.concatenate(halves), out),
                f"{name}: row tiles differ from the full frame")
        record[kname] = dict(max_abs_err=float(np.abs(out - ref).max()))
        phase(f"7 {kname} vs plain", scene=name, rays=int(c_k),
              max_abs_err=np.abs(out - ref).max(),
              pixels_bit_equal=f"{np.mean(np.all(out == ref, axis=-1)):.6f}",
              row_tiles="equal")

    # --- phase 8: fused vs wavefront launch, 256², spl 4, depth 4 ---
    w = h = 256
    for name in ("prims", "pbr", "instanced", "smooth_knot"):
        scene, camera, kname, atol, _ = scenes[name]
        cam = camera(w, h).params(dev)
        f_fused, r_fused = render_accumulate(scene, cam, Film.create(h, w, dev),
                                             w, h, samples_per_launch=4,
                                             max_depth=4, impl="fused")
        f_wave, r_wave = render_accumulate(scene, cam, Film.create(h, w, dev),
                                           w, h, samples_per_launch=4,
                                           max_depth=4, impl="wavefront")
        a, b = to_np(f_fused.accum), to_np(f_wave.accum)
        phase(f"8 {name} fused vs wavefront", max_abs_diff=np.abs(a - b).max(),
              mean_abs_diff=np.abs(a - b).mean(), rays_fused=int(r_fused),
              rays_wavefront=int(r_wave),
              pixels_bit_equal=f"{np.mean(np.all(a == b, axis=-1)):.6f}")
        require(int(r_fused) == int(r_wave),
                f"{name}: fused and wavefront ray counts differ")
        require(np.allclose(a, b, atol=atol, rtol=RTOL),
                f"{name}: fused and wavefront images differ")

    # --- phase 9: the headlines ---
    W, H, spl = (HEADLINE[k] for k in ("width", "height", "spl"))
    launches = {}
    for name, (scene, camera, kname, atol, depth) in scenes.items():
        cam = camera(W, H).params(dev)
        film, rays_f, dt_f, peak_f, first_f, first_rays_f, n_f, _ = (
            timed_launches(scene, cam, W, H, spl, depth, "auto", 2, dev))
        _, rays_w, dt_w, peak_w, first_w, first_rays_w, n_w, _ = (
            timed_launches(scene, cam, W, H, spl, depth, "wavefront", 1, dev))
        fused_keys = [k for k in n_f if k.startswith("pt_fused_")]
        require(n_f[kname] == 3 and n_f["bf_closest"] == 0
                and n_f["bf_any"] == 0
                and all(n_f[k] == 0 for k in fused_keys if k != kname),
                f"{name}: the auto path did not run {kname} alone")
        # the wavefront's 2 launches x spl samples x depth bounces, each one
        # closest and one any-hit query, one launch per instance per query
        queries = 2 * spl * depth * max(scene.instances.num, 1)
        require(n_w["bf_closest"] == queries and n_w["bf_any"] == queries
                and all(n_w[k] == 0 for k in fused_keys),
                f"{name}: the wavefront path did not run kernels 1-2 "
                f"{queries} times each")
        a, b = to_np(first_f.accum), to_np(first_w.accum)
        require(first_rays_f == first_rays_w,
                f"{name} headline ray counts differ: {first_rays_f} vs "
                f"{first_rays_w}")
        require(np.allclose(a, b, atol=atol, rtol=RTOL),
                f"{name} headline images differ by {np.abs(a - b).max()}")
        img = to_np(film.accum)
        require(img.shape == (H, W, 3) and np.isfinite(img).all()
                and img.mean() > 0, f"{name} headline image not finite / "
                                    f"empty")
        ms_f, ms_w = 1e3 * dt_f / 2, 1e3 * dt_w
        head_err = float(np.abs(a - b).max())
        phase(f"9 {name} headline", card=repr(card), kernel=kname,
              dim=f"{W}x{H}", spl=spl, depth=depth,
              fused_ms_per_launch=f"{ms_f:.2f}",
              mrays_per_s=f"{rays_f / dt_f / 1e6:.1f}",
              msamples_per_s=f"{2 * W * H * spl / dt_f / 1e6:.1f}",
              rays_per_launch=rays_f // 2, first_launch_rays=first_rays_f,
              wavefront_ms_per_launch=f"{ms_w:.2f}",
              wavefront_mrays_per_s=f"{rays_w / dt_w / 1e6:.1f}",
              peak_mem_mib=f"{peak_f / 2**20:.0f}",
              wavefront_peak_mem_mib=f"{peak_w / 2**20:.0f}",
              image_mean=f"{img.mean():.5f}",
              fused_vs_wavefront_max_abs_diff=head_err,
              pixels_bit_equal=f"{np.mean(np.all(a == b, axis=-1)):.6f}",
              auto_launches={k: n_f[k] for k in ("bf_closest", "bf_any",
                                                 kname)},
              wavefront_launches={k: n_w[k] for k in ("bf_closest", "bf_any",
                                                      kname)})
        launches[kname] = n_f[kname]
        # Bound per launch: of the traced rays at least half are
        # closest-hit rays (each NEE shadow ray follows a hit), each tested
        # against every triangle and prim (on an instanced scene, the sum
        # of the ranges, plus its move into each instance's object space;
        # on a smooth mesh plus the normal's interpolation); a shadow ray
        # needs one test at the least. Bytes: the radiance and count planes
        # written once.
        ranges = pallas_pt.fused_inst_ranges(scene)
        tests = (sum(hi - lo for lo, hi in ranges) if ranges
                 else scene.num_triangles)
        per_closest = (PAIR_OPS * tests + INST_XF_OPS * len(ranges)
                       + (SMOOTH_OPS if scene.geom.smooth and not ranges
                          else 0)
                       + sum(PRIM_OPS[k] for k in scene.prims.kinds_static))
        rays_launch = rays_f // 2
        record[kname]["max_abs_err"] = max(record[kname]["max_abs_err"],
                                           head_err)
        record[kname].update(
            ms=ms_f, plain_ms=ms_w, plain_blocks="all",
            **bound((rays_launch // 2) * (per_closest + PAIR_OPS),
                    W * H * 16))
    return launches


def texture_phases(dev, card, record):
    """Phases k1-k3: the fused kernel's texture instantiations (3' tex)
    against their plain version, the wavefront's texture lanes, on (i)
    bench.py:219-246's textured scene (4 triangles; 256 / 128 / 128 / 64
    maps in one 256x256, 9-level bundle; metallic 1, roughness 1 under an
    mr map, so <tex, specular, pbr>), (ii) its smooth-normal and (iii) its
    base-map-only variant at tests/test_fused_textures.py:29-63's sizes
    (<tex, pbr>): (k1) render_sum_fused against render_sum_plain at 64²,
    spl 2, depth 3: ray counts equal, radiance within atol 2e-3 / rtol
    1e-3, two row tiles equal to the full frame; (k2) render_accumulate, fused
    against wavefront, 256², spl 4, depth 3; (k3) the headline of (i)
    (1920x1088, spl 4, depth 3): "auto" (the texture instantiation alone,
    bf_* at 0; 2 timed launches) against "wavefront" (kernels 1-2 and the
    texture lanes; 1), launches counted per path, and the kernel's device
    time alone (CUDA events over 10 render_sum_fused calls at the headline's
    shape). Fills the kernels' record and returns the headline's launch
    count."""
    import torch
    from optix_raytracer_tpu_torch import kernels
    from optix_raytracer_tpu_torch.core.film import Film
    from optix_raytracer_tpu_torch.scene import builtins as B
    from optix_raytracer_tpu_torch.wavefront import pallas_pt
    from optix_raytracer_tpu_torch.wavefront.engine import (_use_fused,
                                                            render_accumulate)
    scenes = {       # name → (scene, fov, instantiation)
        "bench": (B.textured_scene(dev), 40.0),
        "smooth": (B.textured_scene(dev, TEXTURED_SMALL, 0.6, 0.8,
                                    smooth=True), 45.0),
        "base": (B.textured_scene(dev, TEXTURED_SMALL, 0.6, 0.8,
                                  maps="base"), 45.0)}
    scenes = {k: (s, fov, kernels.pt_fused_name(*pallas_pt.fused_variant(s)))
              for k, (s, fov) in scenes.items()}
    head = scenes["bench"][0]
    require(scenes["bench"][2] == "pt_fused_tex_specular_pbr"
            and tuple(head.bundles.shape) == (1, 263, 386, 16)
            and len(head.bundle_meta[0]) == 9,
            "textured scene: not one 256x256, 9-level bundle on "
            "pt_fused_tex_specular_pbr")
    # --- k1: each instantiation vs its plain version, 64², spl 2 ---
    w = h = 64
    sub = torch.tensor(5, dtype=torch.int64, device=dev)
    errs = {}
    for name, (scene, fov, kname) in scenes.items():
        require(_use_fused(scene, "auto"),
                f"textured {name}: auto does not take the fused kernel")
        cam = B.textured_camera(w, h, fov).params(dev)
        out, c_k = pallas_pt.render_sum_fused(scene, cam, w, h, sub,
                                              samples_per_launch=2,
                                              max_depth=3)
        ref, c_p = pallas_pt.render_sum_plain(scene, cam, w, h, sub,
                                              samples_per_launch=2,
                                              max_depth=3)
        out, ref = to_np(out), to_np(ref)
        require(int(c_k) == int(c_p),
                f"textured {name}: ray counts {int(c_k)} != {int(c_p)}")
        require(np.allclose(out, ref, atol=ATOL, rtol=RTOL),
                f"textured {name}: radiance off by "
                f"{np.abs(out - ref).max()}")
        halves = [to_np(pallas_pt.render_sum_fused(
            scene, cam, w, h // 2, sub, samples_per_launch=2,
            max_depth=3, y0=y0, full_width=w, full_height=h)[0])
            for y0 in (0, h // 2)]
        require(np.array_equal(np.concatenate(halves), out),
                f"textured {name}: row tiles differ from the full frame")
        errs[kname] = max(errs.get(kname, 0.0),
                          float(np.abs(out - ref).max()))
        phase(f"k1 {kname} vs plain", scene=name, rays=int(c_k),
              max_abs_err=np.abs(out - ref).max(),
              pixels_bit_equal=(
                  f"{np.mean(np.all(out == ref, axis=-1)):.6f}"),
              row_tiles="equal")

    # --- k2: fused vs wavefront launch, 256², spl 4, depth 3 ---
    w = h = 256
    for name, (scene, fov, kname) in scenes.items():
        cam = B.textured_camera(w, h, fov).params(dev)
        f_fused, r_fused = render_accumulate(
            scene, cam, Film.create(h, w, dev), w, h,
            samples_per_launch=4, max_depth=3, impl="fused")
        f_wave, r_wave = render_accumulate(
            scene, cam, Film.create(h, w, dev), w, h,
            samples_per_launch=4, max_depth=3, impl="wavefront")
        a, b = to_np(f_fused.accum), to_np(f_wave.accum)
        phase(f"k2 {name} fused vs wavefront",
              max_abs_diff=np.abs(a - b).max(),
              mean_abs_diff=np.abs(a - b).mean(),
              rays_fused=int(r_fused), rays_wavefront=int(r_wave),
              pixels_bit_equal=f"{np.mean(np.all(a == b, axis=-1)):.6f}")
        require(int(r_fused) == int(r_wave),
                f"textured {name}: fused and wavefront ray counts differ")
        require(np.allclose(a, b, atol=ATOL, rtol=RTOL),
                f"textured {name}: fused and wavefront images differ")

    # --- k3: the textured headline ---
    W, H, spl, depth = (TEXTURED[k] for k in ("width", "height", "spl",
                                              "depth"))
    kname = scenes["bench"][2]
    cam = B.textured_camera(W, H).params(dev)
    film, rays_f, dt_f, peak_f, first_f, first_rays_f, n_f, _ = (
        timed_launches(head, cam, W, H, spl, depth, "auto", 2, dev))
    _, rays_w, dt_w, peak_w, first_w, first_rays_w, n_w, _ = (
        timed_launches(head, cam, W, H, spl, depth, "wavefront", 1, dev))
    fused_keys = [k for k in n_f if k.startswith("pt_fused_")]
    require(n_f[kname] == 3 and n_f["bf_closest"] == 0 and n_f["bf_any"] == 0
            and all(n_f[k] == 0 for k in fused_keys if k != kname),
            f"textured headline: the auto path did not run {kname} alone")
    queries = 2 * spl * depth
    require(n_w["bf_closest"] == queries and n_w["bf_any"] == queries
            and all(n_w[k] == 0 for k in fused_keys),
            f"textured headline: the wavefront path did not run kernels 1-2 "
            f"{queries} times each")
    a, b = to_np(first_f.accum), to_np(first_w.accum)
    require(first_rays_f == first_rays_w,
            f"textured headline ray counts differ: {first_rays_f} vs "
            f"{first_rays_w}")
    require(np.allclose(a, b, atol=ATOL, rtol=RTOL),
            f"textured headline images differ by {np.abs(a - b).max()}")
    img = to_np(film.accum)
    require(img.shape == (H, W, 3) and np.isfinite(img).all()
            and img.mean() > 0, "textured headline image not finite / empty")
    ms_f, ms_w = 1e3 * dt_f / 2, 1e3 * dt_w
    sub = torch.tensor(0, dtype=torch.int64, device=dev)
    ms_k = cuda_ms(lambda: pallas_pt.render_sum_fused(
        head, cam, W, H, sub, samples_per_launch=spl, max_depth=depth), 10)
    head_err = float(np.abs(a - b).max())
    # Bound per launch: half the traced rays at least are closest-hit rays,
    # each tested against the 4 triangles, its normal interpolated and its
    # hit textured; a shadow ray needs one test at the least. Bytes: the
    # radiance and count planes written, the bundle atlas and the
    # per-triangle plane read once.
    rays_launch = rays_f // 2
    b_head = bound((rays_launch // 2) * (PAIR_OPS * head.num_triangles
                                         + SMOOTH_OPS + TEX_OPS + PAIR_OPS),
                   W * H * 16 + head.bundles.numel() * 4
                   + head.num_triangles * pallas_pt.TEX_ATTR_COLS * 4)
    phase("k3 textured headline", card=repr(card), kernel=kname,
          dim=f"{W}x{H}", spl=spl, depth=depth,
          fused_ms_per_launch=f"{ms_f:.2f}", fused_kernel_ms=f"{ms_k:.3f}",
          mrays_per_s=f"{rays_f / dt_f / 1e6:.1f}",
          msamples_per_s=f"{2 * W * H * spl / dt_f / 1e6:.1f}",
          rays_per_launch=rays_launch, first_launch_rays=first_rays_f,
          wavefront_ms_per_launch=f"{ms_w:.2f}",
          wavefront_mrays_per_s=f"{rays_w / dt_w / 1e6:.1f}",
          wavefront_msamples_per_s=f"{W * H * spl / dt_w / 1e6:.1f}",
          peak_mem_mib=f"{peak_f / 2**20:.0f}",
          wavefront_peak_mem_mib=f"{peak_w / 2**20:.0f}",
          bound_ms=f"{b_head['bound_ms']:.3f}({b_head['bound_by']})",
          image_mean=f"{img.mean():.5f}",
          fused_vs_wavefront_max_abs_diff=head_err,
          pixels_bit_equal=f"{np.mean(np.all(a == b, axis=-1)):.6f}",
          auto_launches={k: n_f[k] for k in ("bf_closest", "bf_any", kname)},
          wavefront_launches={k: n_w[k] for k in ("bf_closest", "bf_any",
                                                  kname)})
    record[kname] = dict(max_abs_err=max(errs[kname], head_err), ms=ms_k,
                         launch_ms=ms_f, plain_ms=ms_w, plain_blocks="all",
                         **b_head)
    return {kname: n_f[kname]}


def texfetch_phase(dev, card, record):
    """Phase l: kernel 9 against its plain version, bit for bit, on the
    A/B's 2M-lane workloads at tile_w 128 / 256 / 512 of a 65,536-row bf16
    atlas; then the A/B of tools/bench_texfetch.py:114-147 on the same
    workloads (CUDA events, mean of 10): the kernel, its plain version and
    torch's row gather from the f32 atlas (the library call), with the
    bound (the distinct rows read, the indices and the f32 rows written,
    over the HBM rate), launches counted over the A/B alone. The record
    takes tile_w 256."""
    from optix_raytracer_tpu_torch import kernels
    from optix_raytracer_tpu_torch.tools import bench_texfetch as T
    atlas, atlas_bf = T.make_atlas(dev)
    errs = []
    for tile_w in T.TILE_WS:
        err, equal = T.parity(tile_w, atlas_bf)
        require(equal, f"texfetch tile_w {tile_w}: kernel 9 differs from "
                       f"its plain version by {err}")
        errs.append(err)
    kernels.reset_launches()
    res = {tile_w: T.ab(tile_w, atlas, atlas_bf, rounds=10)
           for tile_w in T.TILE_WS}
    n = kernels.LAUNCHES["texfetch"]
    require(n > 0, "texfetch never launched in the A/B")
    for tile_w, r in res.items():
        phase(f"l texfetch tile_w {tile_w}", card=repr(card),
              lanes=r["lanes"], rows=r["rows"],
              kernel_ms=f"{r['kernel_ms']:.4f}",
              gather_ms=f"{r['library_ms']:.4f}",
              plain_ms=f"{r['plain_ms']:.4f}",
              bound_ms=f"{r['bound_ms']:.4f}(bytes)",
              gather_over_kernel=f"{r['library_ms'] / r['kernel_ms']:.2f}",
              bit_equal=True)
    r = res[256]
    record["texfetch"] = dict(max_abs_err=max(errs), ms=r["kernel_ms"],
                              plain_ms=r["plain_ms"],
                              library_ms=r["library_ms"],
                              bound_ms=r["bound_ms"], bound_by="bytes",
                              plain_blocks="all")
    return {"texfetch": n}


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
    nvcc = subprocess.run([kernels._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    lib_path, build_s = kernels.build()
    kernels.lib()
    phase("1 device", card=repr(card), torch=torch.__version__,
          cuda=torch.version.cuda, kernel_build_s=f"{build_s:.1f}",
          nvcc=repr(nvcc.strip().splitlines()[-1]))
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
    film, rays_f, dt_f, peak_f, first_f, first_rays_f, n_f, _ = (
        timed_launches(scene, cam, W, H, spl, depth, "auto", 2, dev))
    _, rays_w, dt_w, peak_w, first_w, first_rays_w, n_w, _ = (
        timed_launches(scene, cam, W, H, spl, depth, "wavefront", 1, dev))
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
    # Bound of kernel 3 per launch: of the traced rays at least half are
    # closest-hit rays (each NEE shadow ray follows a hit), each tested
    # against every triangle; a shadow ray needs one test at the least.
    # Bytes: the radiance and count planes written once.
    m = scene.num_triangles
    rays_launch = rays_f // 2
    record["pt_fused_cornell"].update(
        ms=ms_f, plain_ms=ms_w, plain_blocks="all",
        **bound(PAIR_OPS * (rays_launch // 2) * (m + 1), W * H * 16))

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
        record[name].update(ms=k_ms, plain_ms=p_ms, plain_blocks="all")
    # Bounds: every live camera ray tests all m triangles; a shadow ray that
    # is occluded needs one test at the least, one that is not all m. Bytes:
    # the rays and triangle table read once, the hits / occlusion written.
    table = m * (16 + 1) * 4
    live_s = to_np(shadow.tmax > shadow.tmin)
    record["bf_closest"].update(bound(
        PAIR_OPS * int(to_np(cam_rays.tmax > cam_rays.tmin).sum()) * m,
        W * H * (RAY_BYTES + 32) + table))
    record["bf_any"].update(bound(
        PAIR_OPS * (int((live_s & ~occ_k).sum()) * m
                    + int((live_s & occ_k).sum())),
        W * H * (RAY_BYTES + 1) + table))
    phase("6 bf timing", rays=W * H,
          **{f"{n}_ms": f"{t[0]:.3f}" for n, t in times.items()},
          **{f"{n}_plain_ms": f"{t[1]:.3f}" for n, t in times.items()})

    # --- phases 7-9: the fused kernel's specular, PBR and prim variants ---
    variant_launches = variant_phases(dev, card, record)
    launches.update(variant_launches)
    torch.cuda.empty_cache()

    # --- phases k1-k3 and l: the texture variant (3' tex) and kernel 9 ---
    variant_launches.update(texture_phases(dev, card, record))
    launches.update(variant_launches)
    launches.update(texfetch_phase(dev, card, record))
    torch.cuda.empty_cache()

    # --- phases (a)-(d), (h)-(j): the large-mesh path (kernels 4-6) and
    # the queue (kernels 7-8) ---
    launches.update(knot_phases(dev, card, record))
    torch.cuda.empty_cache()

    # --- phases (e)-(g): the supercluster tier (kernels 5c/6c) ---
    launches.update(sc_phases(dev, card, record))

    # --- the record and the verdict ---
    fused_3 = ("optix_raytracer_tpu_torch/csrc/pt_fused.cu",
               "optix_raytracer_tpu/wavefront/pallas_pt.py:1478")

    def fused_source(name):
        for mode in ("inst", "smooth", "tex"):
            if name.startswith(f"pt_fused_{mode}"):
                return (f"optix_raytracer_tpu_torch/csrc/pt_fused_{mode}.cu",
                        fused_3[1])
        return fused_3
    meta = dict(
        bf_closest=("optix_raytracer_tpu_torch/csrc/bf.cu",
                    "optix_raytracer_tpu/accel/pallas_bf.py:174"),
        bf_any=("optix_raytracer_tpu_torch/csrc/bf.cu",
                "optix_raytracer_tpu/accel/pallas_bf.py:200"),
        pt_fused_cornell=fused_3,
        **{name: fused_source(name) for name in variant_launches},
        cluster_cull_exact=("optix_raytracer_tpu_torch/csrc/clusters.cu",
                            "optix_raytracer_tpu/accel/clusters.py:312"),
        cluster_closest=("optix_raytracer_tpu_torch/csrc/clusters.cu",
                         "optix_raytracer_tpu/accel/clusters.py:1150"),
        cluster_any=("optix_raytracer_tpu_torch/csrc/clusters.cu",
                     "optix_raytracer_tpu/accel/clusters.py:1372"),
        cluster_sc_closest=("optix_raytracer_tpu_torch/csrc/clusters.cu",
                            "optix_raytracer_tpu/accel/clusters.py:858"),
        cluster_sc_any=("optix_raytracer_tpu_torch/csrc/clusters.cu",
                        "optix_raytracer_tpu/accel/clusters.py:933"),
        qwalk_oct_cull=("optix_raytracer_tpu_torch/csrc/clusters.cu",
                        "optix_raytracer_tpu/accel/qwalk.py:117"),
        qwalk_closest=("optix_raytracer_tpu_torch/csrc/clusters.cu",
                       "optix_raytracer_tpu/accel/qwalk.py:283"),
        qwalk_any=("optix_raytracer_tpu_torch/csrc/clusters.cu",
                   "optix_raytracer_tpu/accel/qwalk.py:283"),
        texfetch=("optix_raytracer_tpu_torch/csrc/texfetch.cu",
                  "tools/bench_texfetch.py:97"))
    # No single PyTorch call computes a Woop closest hit, a slab cull or a
    # path: library_ms is null for every kernel but kernel 9 (torch's row
    # gather).
    print(json.dumps({"kernels": [
        dict(name=n, route="cuda", source=meta[n][0], replaces=meta[n][1],
             launches=launches[n], **{"library_ms": None, **record[n]})
        for n in meta]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
