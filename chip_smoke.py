#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (optix_raytracer_tpu_torch) on one
CUDA card: builds the hand-written kernels from this checkout, checks each
against its plain PyTorch version (kernels 1-2 in phase 2 on a random mesh,
Cornell rays, random meshes of 1-700 triangles with half their lanes dead
and a table of exact ties, culled by their group boxes, and in phase 6 on
the 1080p Cornell camera and shadow rays and the wavefront's recorded
queries on the Cornell box and the smooth knot, each timed beside its
needed-work, brute-force and SASS issue-floor bounds, through
optix_raytracer_tpu_torch/tools/bench_bf.py), checks the renderer against
the JAX package's engine semantics and the committed numpy-oracle pair, then
times the two main paths: the Cornell headline launch (1920x1088, 16 samples
per launch, depth 4; kernels 1-3) and the large-mesh launch (the
25,202-triangle trefoil-knot scene, 1920x1088, 16 samples per launch, depth
3; kernels 4-6, the cluster-culled traversal), whose kernels are also held
against their plain versions on the 25k knot and on a 500k-triangle knot,
and the same launch through the cluster-major queue (ORT_QWALK=1; kernels
7-8, held against their plain versions and A/B-timed against the walk on the
same sets); then the 4M-triangle knot through the supercluster tier. Between
the Cornell and the knot phases, phases 7-9 hold the fused kernel's
specular, PBR, prim, instance and smooth-normal instantiations (3') against
the wavefront on the bench's prims + glass scene, the PBR Cornell, the
mirror Cornell, the instanced Cornell and a 482-triangle smooth knot, and
time their headline launches (1920x1088, 16 samples per launch, depth 4;
depth 3 on the knot); phases k1-k3 do the same for the texture
instantiations on bench.py's textured scene (its own frame: 1920x1088, 4
samples per launch, depth 3) and two smaller textured variants; phases 7w
and 7c hold all 32 instantiations to the wavefront bit for bit on tables
tested whole and the 24 outside instances on tables the kernel culls by
groups, and phase m prints the group size and the culled tests a ray of the
headlines it culls (through optix_raytracer_tpu_torch/tools/bench_fused.py),
which give their bound; and phase l holds kernel 9, the texture-fetch
study's row fetch, to its plain version and repeats the study's A/B against
torch's row gather; phases r1-r2 hold the counter RNG's two kernels
(csrc/rng.cu) to their plain versions bit for bit at the main path's shapes,
time both beside the bytes bound, and count their launches on one SPD tetra
launch (1920x1088, 16 samples, depth 4) whose film is bit-equal to the same
launch through the plain RNG. Phases w1-w3 drive the Whitted integrator through its
apps: the Whitted headline (768x576, 16 samples, depth 6; kernels 1-2), its
first sample again through kernels 1-2's plain versions (bit-equal), and
the meshviewer's headlight rig on the 25k knot (768x768, 8 samples, depth
3; kernels 4-6, the first sample's queries held against the plain
versions), each run's launches counted on it alone. Phases c1-c4 drive
alpha cutouts and opacity micromaps: the cutouts app (768x768, 32 samples,
depth 4; kernels 1-2), bench.py's six occlusion cells at 2^21 rays
(micromap and loop answers equal, and equal to the plain versions') and
kernel 1 on a 2,400-row unknown split, the opacity-micromap app and the
cutout grid's sample-major path trace (768x768, 8 samples, depth 3;
kernels 4-6), the textured cutout Cornell, the textured Whitted scene and
the displaced micromesh, each first sample bit-equal through the plain
versions. Phases n1-n3 drive the denoiser: `pathtracer --denoise` at the
headline frame (kernel 3 renders, kernel 1 answers render_aovs' camera
query, bit-equal to its plain version; the trained net's HDR invoke, a
256x256 crop held against the CPU), the model kinds timed at that frame
and every invoke case held against the CPU at 128x96, and the
reference's two quality bars on 128x128 renders. Phases v1-v3 drive motion
blur, curves and volumes through their six apps at the apps' default
frames (512x512): `simple_motion_blur --engine` (kernels 1-2 under the
moving triangle's per-path shutter times) and its standalone renderer,
`motion_geometry` (kernel 1 on SRT-keyed object-space rays), `curves`
(capsules and swept spans), `ribbons` and `hair` (swept cubic fur), and
`volume_viewer` standalone, on a NanoVDB grid the phase writes, and
`--engine` (kernels 1-2 answering the volume's scatter shadow rays too);
each first sample's queries and image bit-equal through the plain
versions, or a 64x64 crop held against the CPU, each run's ms a sample,
peak memory and launches of kernels 1-2 printed. Phases a1-a3 drive the
host API (optix_raytracer_tpu_torch/tools/api_probe.py): validation-mode
Pipeline.launch of the Cornell headline, the Whitted scene and the 25k knot
from GAS builds and SBT records, each bit-equal to the direct render on the
assembled scene; the 4,260,002-triangle knot past the cluster cap, its
LBVH built on the card and walked by the walk kernel (bvh_walk_kernel,
timed on camera and shadow rays and held bit for bit against the lock-step
loop on the same rays); and the API's six apps at their defaults. Phases
s1-s4 drive model loading and the last apps
(optix_raytracer_tpu_torch/tools/model_probe.py): a .glb of the 25k knot
(a KTX2 map, a glTF camera and light, a spin) through `meshviewer --model`
(768x768, 8 samples, depth 3; kernels 4-6, the first sample's queries held
against the plain versions, the image bit-equal to the same arrays added
through Scene.add_mesh), the same knot as OBJ through the native parser,
and `--animate 3`; the headless viewer at its defaults (the Cornell box
on kernel 3, bit-equal to the same launches and to a --checkpoint /
--resume split) and its --model frames; four instances of the 25k knot
walking their per-mesh cluster table (each instance's first-bounce sets
held against the plain versions; the image against the same meshes baked
flat); and the hello, triangle, console, custom-primitive,
dynamic-materials and raycasting apps at their CLI defaults. Phases p1-p4
drive the multichip layer and the training tool
(optix_raytracer_tpu_torch/tools/multichip_probe.py): four ranks started
by `multichip.distributed.launch_local` share the card over gloo (with
four cards NCCL gives each its own) and render the Cornell headline as 2
rows x 2 samples, 4 interleaved rows and 2 slices x 2 rows (kernels 1-2 in
every rank), each gathered frame within 1e-5 of the single-process launch
with equal rays; the nvlink app's --check with its textures sharded over
the ranks (kernel 3's texture variant); a sharded checkpoint written by
the ranks, loaded whole and by two ranks, resumed bit-equal; and
train_denoiser's dataset (kernels 3 and 1) and 10 Adam steps, the first
against the CPU's.

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
sys.path.insert(0, ROOT)
try:
    # the knot configurations, probe sets, timing and work counts (the
    # card's peaks: FP32 outside the tensor cores, HBM3)
    from optix_raytracer_tpu_torch.tools.knot_probe import (
        HBM_RATE, KNOT, KNOT_SC, KNOT_STREAM, PAIR_OPS, SLAB_OPS, bound,
        cuda_ms, cull_fields, knot_ray_sets, listed_entries, listed_words,
        main_path_strip_sets, ptxas_report, queue_counts, sc_pair_counts,
        timed_launches, walk_bound, walk_pair_counts)
except ImportError as e:
    raise SystemExit(f"chip_smoke: FAILED: run from a checkout of the "
                     f"repository ({e})")
ORACLE = os.path.join(ROOT, "tools", "oracle_cache",
                      "cornell_d256x256_spp928_depth4_seed{}.npz")
ATOL, RTOL = 2e-3, 1e-3          # tests/test_fused_kernel.py:77-78
HEADLINE = dict(width=1920, height=1088, spl=16, depth=4)   # bench.py:18-21
# List entries (block x cluster pairs, 32,768 ray-triangle tests each) past
# which the plain walks run on a subset of blocks (about 2 s on the card).
PLAIN_WALK_ENTRIES = 200_000
# The same for the plain supercluster walks, counted in member visits
# (block x crossed member cluster).
PLAIN_SC_VISITS = 60_000
# The dropped-pair audits of kernels 5 / 6 and 5c / 6c: the block sample is
# this many times wider than the plain walks' subset, and an audit stops
# after this many seconds per ray set.
SC_AUDIT_WIDER = 8
SC_AUDIT_S = 8.0
# Kernels 5 / 6 audit both walks of each set, each for half that.
WALK_AUDIT_S = SC_AUDIT_S / 2
# The queue's capacity, work items per octet of the padded batch
# (optix_raytracer_tpu/accel/qwalk.py:307, the default of both packages).
QWALK_QF = 6
# Queue steps (256 marshalled rays x one cluster) past which kernel 8's
# plain version runs on every k-th step only.
PLAIN_QUEUE_STEPS = 4096
# Kernels 1-2's table sizes of phase 2: across the group cutoff (10
# triangles), the Cornell box's 32, the smooth knot's 482 and past the
# fused kernel's 512.
BF_TRIS = (1, 9, 10, 31, 32, 33, 257, 482, 700)
# Phase 6's kernel 1-2 sets (tools/bench_bf.py): the 1080p Cornell camera
# and shadow rays, the wavefront's recorded queries of the first sample on
# the Cornell box (bounces 0-3) and the smooth knot (bounces 0-2).
BF_SETS = ("cornell_camera", "cornell_shadow",
           *(f"cornell_b{k}{s}" for k in range(4) for s in ("", "_shadow")),
           *(f"knot_b{k}{s}" for k in range(3) for s in ("", "_shadow")))

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


# Phases p1-p4: the tiles at the headline, nvlink --check at a budget that
# shards its stacks over the 4 ranks, the checkpointed film, and the
# training tool's dataset (RES 256, clean 1024 spp) and steps.
P_TILES = HEADLINE
P_NVLINK = dict(w=256, h=256, samples=4, tex_px=256, budget=1 << 20)
P_CKPT = dict(w=512, h=512, spl=4)
P_TRAIN = dict(res=256, patch=128, batch=8, steps=10, clean_spp=1024)


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# Seconds since the script started, printed on each phase line (t=), so a
# run shows where its time goes.
T0 = time.perf_counter()


def phase(name, **fields):
    print(f"[{name}] t={time.perf_counter() - T0:.1f} "
          + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def to_np(t):
    return t.detach().cpu().numpy()


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


def fmt(r):
    """A parity result as phase fields: times to the microsecond, each
    bound as its milliseconds and what bounds it, and a walk's bound its
    needed pair tests."""
    out = {}
    for k, v in r.items():
        if k.endswith(("_bound", "_floor")):
            out[f"{k}_ms"] = f"{v['bound_ms']:.3f}({v['bound_by']})"
            if "bound_brute_ms" in v:
                out[f"{k}_brute_ms"] = f"{v['bound_brute_ms']:.3f}"
            if "pairs" in v:
                out[f"{k}_pairs"] = v["pairs"]
        elif isinstance(v, float) and k.endswith("ms"):
            out[k] = f"{v:.3f}"
        else:
            out[k] = v
    return out


def compare_hits(out, ref, what, mixed=True):
    """Kernel-1 bars of tests/test_pallas_intersect.py:37-45 (ids equal, t /
    uv / normals within them) → (the max absolute difference over the
    float outputs of hit rays, the hit rays whose t, uv or normal differ in
    any bit: phases 2 and 6 require 0, as kernel 1 was bit-equal there
    before its redesign). mixed: the set must hold both hits and misses."""
    for k in ("prim_id", "mat_id"):
        require(np.array_equal(to_np(out[k]), to_np(ref[k])),
                f"{what}: {k} differs from the plain version")
    hit = to_np(ref["prim_id"]) >= 0
    require(hit.any() and ((~hit).any() or not mixed),
            f"{what}: degenerate test rays")
    err, differ = 0.0, np.zeros(hit.sum(), dtype=bool)
    for k, tol in (("t", dict(rtol=1e-5, atol=0)),
                   ("uv", dict(rtol=0, atol=1e-4)),
                   ("normal", dict(rtol=0, atol=1e-5))):
        a, b = to_np(out[k])[hit], to_np(ref[k])[hit]
        require(np.allclose(a, b, **tol), f"{what}: {k} outside {tol}")
        err = max(err, float(np.abs(a - b).max()))
        bits = a.view(np.int32) != b.view(np.int32)
        differ |= bits.reshape(len(bits), -1).any(axis=1)
    return err, int(differ.sum())


def random_case(device, num_tris=40, n_rays=1500, seed=7, dead=0.0,
                dup=False, aim=False):
    """A random mesh (triangle 17 degenerate where there is one) and rays
    around it; with aim half of them toward a triangle's centroid, a `dead`
    share of them with an empty window (tmax 0 or tmax = tmin); with dup
    the table twice over, so that every hit is an exact tie between rows
    num_tris apart."""
    import torch
    from optix_raytracer_tpu_torch.accel.geometry import build_triangle_geometry
    from optix_raytracer_tpu_torch.core.rays import Rays
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (num_tris, 3))
    verts = np.concatenate([v0, v0 + rng.uniform(-1, 1, (num_tris, 3)),
                            v0 + rng.uniform(-1, 1, (num_tris, 3))])
    idx = np.arange(3 * num_tris).reshape(3, num_tris).T.copy()
    if num_tris > 17:
        idx[17, 2] = idx[17, 1]
    if dup:
        idx = np.concatenate([idx, idx])
    geom = build_triangle_geometry(verts.astype(np.float32),
                                   idx.astype(np.int32), device)
    require(num_tris <= 17 or not bool(geom.valid[17]),
            "degenerate triangle not flagged")
    tri_mat = torch.as_tensor(rng.integers(0, 5, len(idx)).astype(np.int32),
                              device=device)
    o = rng.uniform(-3, 3, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    if aim:
        tri = verts.reshape(3, num_tris, 3)
        half = rng.random(n_rays) < 0.5
        pick = rng.integers(0, num_tris, int(half.sum()))
        d[half] = tri.mean(axis=0)[pick] - o[half]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays.make(torch.as_tensor(o, device=device),
                     torch.as_tensor(d, device=device), tmin=1e-3, tmax=50.0)
    if dead:
        gone = rng.random(n_rays) < dead
        tmax = np.where(gone, np.where(rng.random(n_rays) < 0.5, 0.0, 1e-3),
                        50.0).astype(np.float32)
        rays = Rays(rays.origin, rays.direction, rays.tmin,
                    torch.as_tensor(tmax, device=device))
    return geom, tri_mat, rays


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


def hits_dict(h):
    return {f: getattr(h, f) for f in ("t", "prim_id", "mat_id", "uv",
                                       "normal")}


def cull_parity(cl, packed, what, out):
    """Kernel 4 against its plain version on cl's table (a cluster set, or
    the supercluster facade): tn / gm and the compacted counts / lists /
    bounds bit-equal. Adds its CUDA-event times, its bound (the needed
    work's and brute force's) and its test counts (cull_fields) to `out`
    and returns the kernel's compacted lists."""
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
    out.update(
        cull_ms=cuda_ms(lambda: C.exact_cull(cl.aabb, packed, n_blocks,
                                             c_pad), 10),
        cull_plain_ms=cuda_ms(lambda: C.exact_cull_plain(
            cl.aabb, packed, n_blocks, c_pad), 1),
        **cull_fields(cl.aabb, packed, 8, "cull"))
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
    walks' rows bit-equal and their occlusion equal. Returns the errors,
    both kernels' CUDA-event times and bounds on all blocks, their pair
    tests at the block, warp and ray granularity and under the admission
    rule (walk_pair_counts; needed: the bound's), the dropped-pair audit of
    both walks (walk_audit, on a block sample SC_AUDIT_WIDER times wider
    than the plain walks'), and the plain versions' times.

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
    full = (counts, lists, tnear, cl.comp, cl.aabb, packed)
    blocks, (pc, pl, pt, pp) = block_subset(
        counts, PLAIN_WALK_ENTRIES, counts, lists, tnear,
        packed.reshape(n_blocks, C.SUB, 8))
    part = (pc, pl, pt, cl.comp, cl.aabb, pp.reshape(-1, 8))
    tmax = part[5][:, 7]
    live = torch.repeat_interleave(part[0].reshape(-1) > 0, C.SUB)

    def hits(rows):
        return hits_dict(C._hits_from_rows(rows, live, tmax))

    rows_k = C.walk_closest(*part, gate)
    rows_p = C.walk_closest_plain(*part, gate)
    out["closest_err"] = compare_hits(hits(rows_k), hits(rows_p), what)[0]
    require(torch.equal(rows_k.view(torch.int32), rows_p.view(torch.int32)),
            f"{what}: closest rows differ from the plain version (max abs "
            f"err {out['closest_err']})")
    out["rows_bit_equal"] = True
    occ_k, occ_p = C.walk_any(*part, gate), C.walk_any_plain(*part, gate)
    out["any_mismatches"] = int((occ_k != occ_p).sum())
    require(out["any_mismatches"] == 0, f"{what}: occlusion differs")
    out["occluded"] = int(occ_k.sum())
    entries = int(counts.sum())
    out["mean_clusters_per_block"] = entries / n_blocks
    out["walk_blocks"] = (f"{part[0].shape[0]} of {n_blocks}"
                          if blocks is not None else "all")
    boxes = C._aabb_rows(cl)[:, :, None]                     # [c_pad, 6, 1]
    rows_full, occ_full = C.walk_closest(*full, gate), C.walk_any(*full, gate)
    stride = max(1, -(-entries // (SC_AUDIT_WIDER * PLAIN_WALK_ENTRIES)))
    audits = {f"{w}_{k}": v for w, res, closest in (
        ("closest", rows_full, True), ("any", occ_full, False))
        for k, v in walk_audit(counts, lists, cl.comp, cl.aabb, packed, res,
                               closest, gate, stride).items()}
    pairs = {f"{w}_pairs_{k}": v for w, res, closest in (
        ("closest", rows_full, True), ("any", occ_full, False))
        for k, v in walk_pair_counts(counts, lists, cl.aabb, packed, res,
                                     closest, gate).items()}
    out.update(
        closest_ms=cuda_ms(lambda: C.walk_closest(*full, gate), 10),
        closest_plain_ms=cuda_ms(lambda: C.walk_closest_plain(*part, gate),
                                 1),
        any_ms=cuda_ms(lambda: C.walk_any(*full, gate), 10),
        any_plain_ms=cuda_ms(lambda: C.walk_any_plain(*part, gate), 1),
        closest_bound=walk_bound(counts, lists, boxes, cl.num_clusters,
                                 packed, rows_full, True),
        any_bound=walk_bound(counts, lists, boxes, cl.num_clusters, packed,
                             occ_full, False),
        **pairs, **audits)
    if blocks is not None:
        out.update(
            closest_subset_ms=cuda_ms(lambda: C.walk_closest(*part, gate), 10),
            any_subset_ms=cuda_ms(lambda: C.walk_any(*part, gate), 10))
    return out


def sc_parity(cl, rays, exact, what, timed):
    """Kernels 5c and 6c (and kernel 4 on the supercluster facade, where the
    cull is exact) against their plain versions on one ray set: cull tables
    and lists bit-equal, 5c's rows bit-equal, 6c's occlusion equal. Both
    walks are compared and timed on all blocks (mean of 10); the `timed`
    one ("closest" or "any", the set's own query) also plain on the
    compared blocks, its bound counted on all blocks (walk_bound), its pair
    tests counted (sc_pair_counts) and its dropped pairs audited
    (sc_audit, on a block sample SC_AUDIT_WIDER times wider). Past
    PLAIN_SC_VISITS member visits the comparison runs on every k-th block.
    closest_err is the max abs difference of the rows, any_mismatches the
    differing occlusion flags."""
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
    result = walk(*full)
    pairs = sc_pair_counts(counts, lists, member, packed, result, closest)
    stride = max(1, -(-int(visits.sum()) // (SC_AUDIT_WIDER
                                              * PLAIN_SC_VISITS)))
    out.update(
        rows_bit_equal=True,
        compared_hits=int((hits.prim_id >= 0).sum()),
        compared_occluded=int(occ_k.sum()),
        entries_per_block=entries / n_blocks,
        members_per_entry=int(visits.sum()) / max(entries, 1),
        member_visits=int(visits.sum()),
        walk_blocks=(f"{pc.shape[0]} of {n_blocks}" if blocks is not None
                     else "all"),
        closest_ms=cuda_ms(lambda: C.walk_sc_closest(*full), 10),
        any_ms=cuda_ms(lambda: C.walk_sc_any(*full), 10),
        **{f"{timed}_plain_ms": cuda_ms(lambda: plain(*part), 1),
           f"{timed}_bound": walk_bound(counts, lists, member,
                                        cl.num_clusters, packed, result,
                                        closest, sc=member.shape[2])},
        **{f"pairs_{k}": v for k, v in pairs.items()},
        **sc_audit(counts, lists, cl.comp, member, packed, result, closest,
                   stride))
    return out


def _audit(counts, lists, comp, packed, out, closest, stride, dropped,
           cap_s):
    """The dropped-pair audit: on every `stride`-th block (a wider sample
    than the plain walks'), front to back until `cap_s` seconds have
    passed, every pair of the plain walks that the admission rule drops
    (taken at the walk's final state, a superset of what the kernel drops)
    is Woop-tested in PyTorch over the cluster's 128 slots. `dropped`(b,
    words, a, best) → (comp rows [P], entry index [P], dropped rays [P,
    256]) gives them for a chunk of listed entries (blocks b, list words,
    rays a [E, 256, 8], best t [E, 256] or None). A dropped pair may hold
    no accepted hit at a t at or below the ray's row t (closest), and no
    accepted hit at all for a ray the walk left unoccluded (any-hit). Fails
    on any → dict(audit_blocks, audit_entries, audit_pairs (slot tests))."""
    import torch
    from optix_raytracer_tpu_torch.accel import clusters as C
    nb = counts.numel()
    rays = packed.reshape(nb, C.SUB, 8)
    sample = torch.zeros(nb, dtype=torch.bool, device=packed.device)
    sample[::stride] = True
    be, we = listed_words(counts, lists)
    keep = sample[be]
    be, we = be[keep], we[keep]
    if closest:
        best = out[:, 0].reshape(nb, C.SUB)
    else:
        open_ray = (out == 0).reshape(nb, C.SUB)
    t0 = time.perf_counter()
    done = pairs = bad = 0
    chunk = 128
    while done < be.numel() and time.perf_counter() - t0 < cap_s:
        b, w = be[done:done + chunk], we[done:done + chunk]
        rows, e, drop = dropped(b, w, rays[b], best[b] if closest else None)
        if not closest:
            drop = drop & open_ray[b[e]]
        ok, tt, _, _ = C._pair_ok(comp[rows], rays[b[e]], None, False)
        hit = ok & drop[:, :, None]
        if closest:
            hit = hit & (tt <= best[b[e]][:, :, None])
        bad += int(hit.sum())
        pairs += int(drop.sum()) * C.LANES
        done += b.numel()
    torch.cuda.synchronize()
    n_blocks = int(torch.unique(be[:done]).numel()) if done else 0
    require(bad == 0, f"{bad} dropped pairs hold a hit that could change a "
                       f"result")
    return dict(audit_blocks=f"{n_blocks} of {nb}", audit_entries=done,
                audit_pairs=pairs)


def walk_audit(counts, lists, comp, aabb, packed, out, closest, gate,
               stride):
    """The dropped-pair audit of kernels 5 / 6 (`_audit`, WALK_AUDIT_S a
    walk): the plain walks' pairs are every ray of the block (of a 32-ray
    group whose gate bit is set, when `gate`) against each listed cluster;
    the rule is `admitted_pairs_plain`."""
    import torch
    from optix_raytracer_tpu_torch.accel import clusters as C
    boxes = C._entry_boxes(aabb)

    def dropped(b, w, a, best):
        c, gm = (w & 0xFFFF).long(), (w >> 16) & 0xFF
        tested = (C._group_bits(gm) if gate
                  else torch.ones(a.shape[:2], dtype=torch.bool,
                                  device=a.device))
        adm = C.admitted_pairs_plain(a, boxes[c], gm, gate, best)
        return c, torch.arange(b.numel(), device=b.device), tested & ~adm
    return _audit(counts, lists, comp, packed, out, closest, stride, dropped,
                  WALK_AUDIT_S)


def sc_audit(counts, lists, comp, member, packed, out, closest, stride):
    """The dropped-pair audit of kernels 5c / 6c (`_audit`): the plain
    walks' pairs are every ray of the block against each block-union member
    of each listed supercluster; the rule is `sc_admitted_pairs_plain`."""
    import torch
    from optix_raytracer_tpu_torch.accel import clusters as C
    m = member.shape[2]

    def dropped(b, w, a, best):
        s = (w & 0xFFFF).long()
        union = C._member_cross(a, member[s]).any(dim=1)        # [E, M]
        drop = ~C.sc_admitted_pairs_plain(a, member[s], best)
        e, c = torch.nonzero(union, as_tuple=True)
        return s[e] * m + c, e, drop[e, :, c]
    return _audit(counts, lists, comp, packed, out, closest, stride, dropped,
                  SC_AUDIT_S)


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
    bound on this set (walk_bound): kernel 8 answers the same query.
    Kernel 8's lane tests a step (tested / admitted / needed) and the
    queue's own floor (marshalled bytes against admitted pair tests) are
    queue_counts'."""
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
    sub_k = Q._run_queue(closest, cl.comp, sub, qrays, cl.aabb)
    sub_p = plain(sub, qrays, cl.comp)
    full_k = Q._run_queue(closest, cl.comp, live, qrays, cl.aabb)
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
        queue_ms=cuda_ms(lambda: Q._run_queue(closest, cl.comp, live, qrays,
                                              cl.aabb), 10),
        queue_plain_ms=cuda_ms(lambda: plain(sub, qrays, cl.comp), 1),
        queue_subset_ms=cuda_ms(lambda: Q._run_queue(closest, cl.comp, sub,
                                                     qrays, cl.aabb), 10),
        query_ms=cuda_ms(lambda: query(cl, rays, qf=qf_fit), 10),
        walk_query_ms=cuda_ms(lambda: walk(cl, rays, exact=True,
                                           group_walk=gate), 10),
        **cull_fields(cl.aabb, packed, 4, "oct"),
        **queue_counts(live, qrays, cl.aabb, n_items, closest),
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
    bounce-1 queries (kernel 8: the walk's bound and the queue's own
    floor) and prints kernel 8's registers and spills (ptxas)."""
    from optix_raytracer_tpu_torch import kernels
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
            **src["queue_bound"], queue_floor_ms=src["queue_floor"][
                "bound_ms"], queue_floor_by=src["queue_floor"]["bound_by"],
            plain_blocks=f"steps {src['plain_steps']}")
    log = kernels.build()[0].parent / "nvcc.log"
    phase("h kernel 8 ptxas", report=ptxas_report(log, ("qwalk_kernel",)))


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
    # both walks on every set of phases b and c, all blocks
    for name, key in (("cluster_closest", "closest_ms"),
                      ("cluster_any", "any_ms")):
        record[name]["sets_ms"] = {k: r[key] for k, r in res.items()}

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


def whitted_query_parity(cl, call, what):
    """One recorded cluster query of the Whitted path against the plain
    versions of its kernels: an exact-cull query's kernel 4 tn / gm
    bit-equal, then the walk it asked for (kernel 5 rows bit-equal, or
    kernel 6 occlusion equal), on every k-th block past PLAIN_WALK_ENTRIES
    list entries → dict(live rays, list entries, blocks compared, max abs
    err)."""
    import torch
    from optix_raytracer_tpu_torch.accel import clusters as C
    rays, exact = call["rays"], call["exact"]
    gate = bool(exact and call["group_walk"]
                and cl.num_clusters <= C.MAX_CLUSTERS)
    n = rays.tmin.shape[0]
    packed = C._pack_rays(rays, C._padded(n))
    n_blocks = packed.shape[0] // C.SUB
    n_super = n_blocks // C.GROUPS
    if exact and cl.c_pad <= C.MAX_CLUSTERS:
        tn_k, gm_k = C.exact_cull(cl.aabb, packed, n_blocks, cl.c_pad)
        tn_p, gm_p = C.exact_cull_plain(cl.aabb, packed, n_blocks, cl.c_pad)
        require(torch.equal(tn_k.view(torch.int32), tn_p.view(torch.int32))
                and torch.equal(gm_k, gm_p), f"{what}: exact cull differs")
        culled = C._compact(cl, *C._cull_tables(tn_k, gm_k), n_super)
    else:
        culled = C._cull(cl, packed, n_super, cl.c_pad, exact=exact)
    counts, lists, tnear = (t.reshape(n_blocks, -1) for t in culled)
    blocks, (pc, pl, pt, pp) = block_subset(
        counts, PLAIN_WALK_ENTRIES, counts, lists, tnear,
        packed.reshape(n_blocks, C.SUB, 8))
    part = (pc, pl, pt, cl.comp, cl.aabb, pp.reshape(-1, 8))
    err = 0.0
    if call["kind"] == "closest":
        rows_k = C.walk_closest(*part, gate)
        rows_p = C.walk_closest_plain(*part, gate)
        err = float((rows_k - rows_p).abs().max()) if rows_k.numel() else 0.0
        require(torch.equal(rows_k.view(torch.int32), rows_p.view(torch.int32)),
                f"{what}: closest rows differ from the plain version")
    else:
        occ_k, occ_p = C.walk_any(*part, gate), C.walk_any_plain(*part, gate)
        require(torch.equal(occ_k, occ_p), f"{what}: occlusion differs")
    return dict(live=int((rays.tmax > rays.tmin).sum()),
                entries=int(counts.sum()),
                blocks=(f"{pc.shape[0]} of {n_blocks}" if blocks is not None
                        else "all"), max_abs_err=err)


def whitted_phases(dev, card, record):
    """Phases w1-w3: the Whitted integrator through its apps. (w1) the
    Whitted headline (apps/whitted.py's defaults: 768x576, 16 samples, depth
    6; kernels 1-2) through apps.whitted.render, launches counted on that
    run alone, with the per-sample time, queries, live rays, peak memory,
    the image and the region checks of tests/test_primitives_whitted.py;
    (w2) its first sample again with kernels 1-2 swapped for their plain
    versions, bit-equal; (w3) the meshviewer's headlight rig on the 25k
    knot (768x768, 8 samples, depth 3; kernels 4-6) through
    apps.meshviewer.render, launches counted on that run alone, with the
    first sample's cluster queries held against the plain versions
    (whitted_query_parity). Adds each kernel's launches on its run to its
    record as whitted_launches."""
    import torch
    from optix_raytracer_tpu_torch import kernels
    from optix_raytracer_tpu_torch.apps import meshviewer
    from optix_raytracer_tpu_torch.apps import whitted as whitted_app
    from optix_raytracer_tpu_torch.scene.builtins import (knot_host_scene,
                                                         whitted_scene)
    from optix_raytracer_tpu_torch.tools.whitted_probe import (
        KNOT_RIG, WHITTED, plain_queries, recorded_queries)
    from optix_raytracer_tpu_torch.wavefront.whitted import render_whitted

    def timed(fn, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # --- w1: the Whitted headline ---
    W, H, spl, depth = (WHITTED[k] for k in ("width", "height", "spl",
                                             "depth"))
    scene = whitted_scene(dev)
    with recorded_queries() as calls:
        (first, _, first_rays), first_s = timed(
            whitted_app.render, W, H, samples=1, max_depth=depth,
            scene=scene, device=dev)
    queries = len(calls)
    require(queries == depth * (1 + scene.lights.num)
            and {c["route"] for c in calls} == {"bf"},
            f"w1: {queries} queries a sample, routes "
            f"{ {c['route'] for c in calls} }")
    live_closest = [int((c["rays"].tmax > c["rays"].tmin).sum())
                    for c in calls if c["kind"] == "closest"]
    del calls
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    (accum, film, rays), dt = timed(whitted_app.render, W, H, samples=spl,
                                    max_depth=depth, scene=scene, device=dev)
    n_w = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    for name in ("bf_closest", "bf_any"):
        require(n_w[name] > 0, f"{name} never launched on the Whitted path")
    img = to_np(accum)
    require(img.shape == (H, W, 3) and np.isfinite(img).all()
            and (img >= 0).all(), "Whitted image not finite / negative")
    require(int(film.subframe) == spl, "Whitted film subframe")
    # tests/test_primitives_whitted.py:90-108 at 96x72, scaled: the sky at
    # the top is the blue miss color, the checker floor's red is high and
    # its luminance varies (shadows and checks)
    sy, sx = H / 72, W / 96
    sky = img[int(2 * sy), int(48 * sx)]
    floor_red = img[-int(6 * sy):].reshape(-1, 3)[:, 0].mean()
    floor_std = img[-int(20 * sy):].mean(axis=-1).std()
    require(sky[2] > sky[0], f"Whitted sky {sky} is not blue")
    require(floor_red > 0.3, f"Whitted floor red {floor_red} <= 0.3")
    require(floor_std > 0.05, f"Whitted floor std {floor_std} <= 0.05")
    phase("w1 whitted headline", card=repr(card), dim=f"{W}x{H}", spl=spl,
          depth=depth, ms_per_sample=f"{1e3 * dt / spl:.2f}",
          first_sample_ms=f"{1e3 * first_s:.2f}",
          queries_per_sample=queries,
          rays_per_sample=int(rays) // spl,
          live_closest_rays_first_sample=live_closest,
          mrays_per_s=f"{int(rays) / dt / 1e6:.1f}",
          peak_mem_mib=f"{peak / 2**20:.0f}", image_mean=f"{img.mean():.5f}",
          sky=np.round(sky, 4).tolist(), floor_red=f"{floor_red:.4f}",
          floor_std=f"{floor_std:.4f}",
          launches={k: n_w[k] for k in ("bf_closest", "bf_any")})

    # --- w2: the first sample through the plain versions of kernels 1-2 ---
    with plain_queries():
        (plain_first, _, plain_rays), plain_s = timed(
            whitted_app.render, W, H, samples=1, max_depth=depth,
            scene=scene, device=dev)
    a, b = to_np(first), to_np(plain_first)
    require(int(first_rays) == int(plain_rays) and np.array_equal(a, b),
            f"w2: the first Whitted sample through kernels 1-2 differs from "
            f"the plain versions' by {np.abs(a - b).max()}")
    phase("w2 whitted plain queries", dim=f"{W}x{H}", bit_equal=True,
          rays=int(first_rays), plain_sample_ms=f"{1e3 * plain_s:.2f}")
    del scene, first, plain_first, accum, film
    torch.cuda.empty_cache()

    # --- w3: the meshviewer's headlight rig on the 25k knot ---
    W, H, spl, depth = (KNOT_RIG[k] for k in ("width", "height", "spl",
                                              "depth"))
    host = knot_host_scene(KNOT_RIG["segments"], KNOT_RIG["sides"])
    cam = host.default_camera(W, H)
    knot, build_s = timed(host.finalize, dev,
                          lights=meshviewer.headlight_rig(cam))
    require(knot.has_clusters and knot.geom.smooth, "w3: no cluster table")
    cam_params = cam.params(dev)
    with recorded_queries() as calls:
        render_whitted(knot, cam_params, W, H, 1, max_depth=depth)
    require(len(calls) == depth * (1 + knot.lights.num)
            and {c["route"] for c in calls} == {"clusters"},
            f"w3: {len(calls)} cluster queries in the first sample")
    errs = []
    for i, call in enumerate(calls):
        what = f"w3 knot rig query {i} ({call['kind']})"
        r = whitted_query_parity(knot.clusters, call, what)
        errs.append(r["max_abs_err"])
        phase(what, exact=call["exact"], **r)
    del calls
    (_, rays_r), dt_r = timed(render_whitted, knot, cam_params, W, H, spl,
                              max_depth=depth)
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    (accum, film, rays), dt = timed(meshviewer.render, None, W, H,
                                    samples=spl, max_depth=depth, scene=host,
                                    device=dev)
    n_k = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    names = ("cluster_cull_exact", "cluster_closest", "cluster_any")
    for name in names:
        require(n_k[name] > 0, f"{name} never launched on the knot rig")
    img = to_np(accum)
    require(img.shape == (H, W, 3) and np.isfinite(img).all()
            and img.mean() > 0, "knot rig image not finite / empty")
    require(int(rays) == int(rays_r), "knot rig ray counts differ")
    phase("w3 knot rig", card=repr(card), dim=f"{W}x{H}", spl=spl,
          depth=depth, triangles=knot.num_triangles,
          clusters=knot.clusters.num_clusters, build_s=f"{build_s:.2f}",
          ms_per_sample=f"{1e3 * dt_r / spl:.2f}",
          app_s=f"{dt:.3f}", rays_per_sample=int(rays) // spl,
          mrays_per_s=f"{int(rays) / dt_r / 1e6:.1f}",
          peak_mem_mib=f"{peak / 2**20:.0f}", image_mean=f"{img.mean():.5f}",
          query_max_abs_err=max(errs),
          launches={k: n_k[k] for k in names})
    # the kernels line: each kernel's launches on the two Whitted runs
    for name, n in (*((k, n_w[k]) for k in ("bf_closest", "bf_any")),
                    *((k, n_k[k]) for k in names)):
        record[name]["whitted_launches"] = n


def cutout_phases(dev, card, record):
    """Phases c1-c4: alpha cutouts and opacity micromaps (the shapes in
    optix_raytracer_tpu_torch/tools/cutout_probe.py). (c1) the cutouts app
    at its defaults (768x768, 32 samples a launch, depth 4; kernels 1-2),
    its first sample bit-equal to the same sample through kernels 1-2's
    plain versions; (c2) bench.py's six occlusion cells at 2^21 rays
    (bench.py:477-580), the micromap and loop answers equal to each other
    and to the plain versions', Mrays/s under bench.py's keys, and kernel 1
    on a 2,400-row unknown split (the circle grid); (c3) the
    opacity-micromap app at its defaults with its classification, and the
    cutout grid's path trace (768x768, 8 samples, depth 3, sample-major;
    kernels 4-6), its first launch's cluster queries of the first strip
    against the plain versions (whitted_query_parity); (c4) the textured
    cutout Cornell and the textured Whitted scene at the cutouts and
    Whitted apps' defaults, and the displaced micromesh app at its
    defaults, each first sample bit-equal through the plain versions. Each
    run's launches are counted on it alone (cutout_launches in the kernels
    line)."""
    import torch
    from optix_raytracer_tpu_torch import kernels
    from optix_raytracer_tpu_torch.accel import pallas_bf
    from optix_raytracer_tpu_torch.apps import (cutouts, displaced_micromesh,
                                                opacity_micromap)
    from optix_raytracer_tpu_torch.core.film import Film
    from optix_raytracer_tpu_torch.scene import builtins
    from optix_raytracer_tpu_torch.tools import cutout_probe as CP
    from optix_raytracer_tpu_torch.tools.whitted_probe import (
        plain_queries, recorded_queries)
    from optix_raytracer_tpu_torch.wavefront import intersect
    from optix_raytracer_tpu_torch.wavefront.engine import render_accumulate
    from optix_raytracer_tpu_torch.wavefront.whitted import render_whitted

    names = ("bf_closest", "bf_any", "cluster_cull_exact", "cluster_closest",
             "cluster_any")
    for name in names:
        record[name]["cutout_launches"] = {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def counted(tag, fn, need):
        """fn() with every count set to 0 just before and read just after →
        (its output, seconds, alpha-loop counts, peak bytes); each kernel of
        `need` must have launched."""
        torch.cuda.synchronize()
        kernels.reset_launches()
        intersect.reset_alpha_stats()
        torch.cuda.reset_peak_memory_stats(dev)
        out, dt = timed(fn)
        n = dict(kernels.LAUNCHES)
        for name in need:
            require(n[name] > 0, f"{tag}: {name} never launched")
        for name in names:
            if n[name]:
                record[name]["cutout_launches"][tag] = n[name]
        return (out, dt, dict(intersect.ALPHA_STATS),
                torch.cuda.max_memory_allocated(dev),
                {k: n[k] for k in names if n[k]})

    def first_sample(tag, render_one):
        """render_one() → (radiance, rays): its output through the kernels
        and through their plain versions, bit-equal → phase fields."""
        (img, rays), dt = timed(render_one)
        with plain_queries():
            (img_p, rays_p), dt_p = timed(render_one)
        a, b = to_np(img), to_np(img_p)
        require(int(rays) == int(rays_p) and np.array_equal(a, b),
                f"{tag}: the first sample through the kernels differs from "
                f"the plain versions' by {np.abs(a - b).max()} "
                f"(rays {int(rays)} vs {int(rays_p)})")
        return dict(first_sample_bit_equal=True, first_rays=int(rays),
                    first_sample_ms=f"{1e3 * dt:.2f}",
                    plain_first_sample_ms=f"{1e3 * dt_p:.2f}")

    def check_image(tag, img, shape):
        img = to_np(img)
        require(img.shape == shape and np.isfinite(img).all()
                and (img >= 0).all() and img.mean() > 0,
                f"{tag}: image not finite / negative / empty")
        return f"{img.mean():.5f}"

    # --- c1: the cutouts app at its defaults ---
    W, H, spl, depth = (CP.CUTOUTS[k] for k in ("width", "height", "spl",
                                                "depth"))
    scene = cutouts.cutout_cornell(dev)
    fields = first_sample("c1", lambda: cutouts.render(
        W, H, samples=1, max_depth=depth, scene=scene, device=dev)[::2])
    (accum, film, rays), dt, alpha, peak, n = counted(
        "c1", lambda: cutouts.render(W, H, samples=spl, max_depth=depth,
                                     scene=scene, device=dev),
        ("bf_closest", "bf_any"))
    require(alpha["steps"] > 0, "c1: no alpha-loop step")
    phase("c1 cutouts app", card=repr(card), dim=f"{W}x{H}", spl=spl,
          depth=depth, ms_per_launch=f"{1e3 * dt:.2f}", rays=int(rays),
          mrays_per_s=f"{int(rays) / dt / 1e6:.1f}",
          solid_tris=scene.omm_solid_geom.num_triangles,
          unknown_tris=scene.omm_unknown_geom.num_triangles,
          alpha_loops=alpha["loops"], alpha_steps=alpha["steps"],
          peak_mem_mib=f"{peak / 2**20:.0f}",
          image_mean=check_image("c1", accum, (H, W, 3)), launches=n,
          **fields)
    del accum, film
    torch.cuda.empty_cache()

    # --- c2: bench.py's six occlusion cells, and kernel 1 past 512 rows ---
    n_rays = CP.OCCLUSION_RAYS
    cells = {}
    for sname, maker in CP.OCCLUSION_SCENES.items():
        sc = maker(dev)
        rays = CP.occlusion_rays(sname, n_rays, 3, dev)
        keys = [k for k, (s_, _) in CP.OCCLUSION_CELLS.items() if s_ == sname]
        answers = {}
        for key in keys:
            query = CP.OCCLUSION_CELLS[key][1]
            occ = CP.occlusion_query(sc, query, rays)           # warm-up
            with plain_queries():
                occ_p = CP.occlusion_query(sc, query, rays)
            require(torch.equal(occ, occ_p),
                    f"c2 {key}: {int((occ != occ_p).sum())} rays differ "
                    f"from the plain versions")
            reps = 3
            _, dt, alpha, _, n = counted(f"c2 {key}", lambda: [
                CP.occlusion_query(sc, query, rays) for _ in range(reps)],
                ())
            cells[key] = reps * n_rays / dt / 1e6
            answers[key] = occ
            phase(f"c2 {key}", card=repr(card), scene=sname, query=query,
                  rays=n_rays, mrays_per_s=f"{cells[key]:.1f}",
                  ms_per_call=f"{1e3 * dt / reps:.2f}",
                  occluded=f"{float(occ.float().mean()):.6f}",
                  alpha_steps_per_call=alpha["steps"] / reps,
                  launches_per_call={k: v // reps for k, v in n.items()},
                  plain_bit_equal=True)
        a, b = (answers[k] for k in keys)
        require(torch.equal(a, b), f"c2 {sname}: the micromap and loop "
                                   f"answers differ on {int((a != b).sum())} "
                                   f"rays")
        del sc, rays, answers
    torch.cuda.empty_cache()
    # kernel 1 on the circle grid's 2,400-triangle unknown split: the
    # micromap query, and the split's first closest-hit step alone
    sc = CP.circle_grid(dev)
    rays = CP.occlusion_rays("circle_grid", n_rays, 4, dev)
    geom, boxes = sc.omm_unknown_geom, sc.omm_boxes[1]
    require(geom.num_triangles == 2400, "c2: circle grid split")
    occ = CP.occlusion_query(sc, "omm", rays)
    with plain_queries():
        occ_p = CP.occlusion_query(sc, "omm", rays)
    require(torch.equal(occ, occ_p), "c2 circle grid: occlusion differs "
                                     "from the plain versions")
    zeros = torch.zeros(geom.num_triangles, dtype=torch.int32, device=dev)
    k1 = pallas_bf.closest_hit(geom.tri_consts, zeros, rays, boxes=boxes)
    err, nbits = compare_hits(
        k1, pallas_bf.closest_hit_plain(geom.tri_consts, zeros, rays),
        "c2 circle grid kernel 1")
    require(nbits == 0, f"c2 circle grid: kernel 1 differs in {nbits} rays")
    k1_ms = cuda_ms(lambda: pallas_bf.closest_hit(geom.tri_consts, zeros,
                                                  rays, boxes=boxes), 5)
    _, dt, alpha, _, n = counted("c2 circle grid", lambda: (
        CP.occlusion_query(sc, "omm", rays)), ("bf_closest",))
    record["bf_closest"]["unknown_split_2400_ms"] = k1_ms
    phase("c2 circle grid", card=repr(card), rays=n_rays,
          unknown_tris=geom.num_triangles,
          solid_tris=sc.omm_solid_geom.num_triangles,
          omm_ms=f"{1e3 * dt:.2f}", alpha_steps=alpha["steps"],
          kernel1_step0_ms=f"{k1_ms:.3f}", kernel1_max_abs_err=err,
          launches=n, plain_bit_equal=True)
    phase("c2 cutout cells (this run, not bench cells)", card=repr(card),
          **{k: f"{v:.1f}" for k, v in cells.items()})
    del sc, rays, occ, occ_p, k1
    torch.cuda.empty_cache()

    # --- c3: the opacity-micromap app, and the cutout grid's path trace ---
    W, H, spl, depth, level = (CP.OMM[k] for k in ("width", "height", "spl",
                                                   "depth", "level"))
    fields = first_sample("c3 omm app", lambda: opacity_micromap.render(
        W, H, samples=1, level=level, device=dev)[::2])
    (accum, stats, rays), dt, alpha, _, n = counted(
        "c3 omm app", lambda: opacity_micromap.render(
            W, H, samples=spl, level=level, device=dev), ("bf_closest",))
    phase("c3 omm app", card=repr(card), dim=f"{W}x{H}", spl=spl,
          depth=depth, level=level, ms_per_launch=f"{1e3 * dt:.2f}",
          rays=int(rays), mrays_per_s=f"{int(rays) / dt / 1e6:.1f}",
          fully_classified_fraction=stats["fully_classified_fraction"],
          opaque_fraction=stats["opaque_fraction"],
          transparent_fraction=stats["transparent_fraction"],
          alpha_steps=alpha["steps"],
          image_mean=check_image("c3 omm app", accum, (H, W, 3)),
          launches=n, **fields)
    W, H, spl, depth = (CP.GRID[k] for k in ("width", "height", "spl",
                                             "depth"))
    grid = cutouts.cutout_grid(dev)
    require(grid.has_clusters and grid.omm_solid_clusters is not None
            and grid.omm_all_certain, "c3: cutout grid tables")
    cam = builtins.cutout_grid_camera(W, H).params(dev)
    with recorded_queries() as calls:
        first, first_rays = render_accumulate(
            grid, cam, Film.create(H, W, dev), W, H, spl, depth)
    tables = {id(grid.clusters): "scene", id(grid.omm_solid_clusters):
              "solid split"}
    require({c["route"] for c in calls} == {"clusters"}
            and {tables.get(id(c["cl"])) for c in calls}
            == {"scene", "solid split"},
            "c3: the grid's queries did not take both cluster tables")
    rows = min(H, max(1, (4 * 1024 * 1024) // (W * spl)))
    strips = -(-H // rows)
    errs = []
    for i, call in enumerate(calls[:len(calls) // strips]):
        what = (f"c3 grid query {i} ({call['kind']}, "
                f"{tables[id(call['cl'])]})")
        r = whitted_query_parity(call["cl"], call, what)
        errs.append(r["max_abs_err"])
        phase(what, exact=call["exact"], **r)
    del calls
    (film, rays), dt, alpha, peak, n = counted(
        "c3 grid", lambda: render_accumulate(grid, cam, first, W, H, spl,
                                             depth),
        ("cluster_cull_exact", "cluster_closest", "cluster_any"))
    phase("c3 cutout grid", card=repr(card), dim=f"{W}x{H}", spl=spl,
          depth=depth, triangles=grid.num_triangles,
          clusters=grid.clusters.num_clusters,
          solid_clusters=grid.omm_solid_clusters.num_clusters,
          ms_per_launch=f"{1e3 * dt:.2f}", rays=int(rays),
          first_rays=int(first_rays),
          mrays_per_s=f"{int(rays) / dt / 1e6:.1f}",
          alpha_steps=alpha["steps"], query_max_abs_err=max(errs),
          peak_mem_mib=f"{peak / 2**20:.0f}",
          image_mean=check_image("c3 grid", film.accum, (H, W, 3)),
          launches=n)
    del grid, first, film
    torch.cuda.empty_cache()

    # --- c4: the textured cutout Cornell, the textured Whitted scene, the
    # displaced micromesh ---
    W, H, spl, depth = (CP.CUTOUTS[k] for k in ("width", "height", "spl",
                                                "depth"))
    scene = cutouts.textured_cutout_cornell(dev)
    fields = first_sample("c4 textured cutout", lambda: cutouts.render(
        W, H, samples=1, max_depth=depth, scene=scene, device=dev)[::2])
    (accum, _, rays), dt, alpha, _, n = counted(
        "c4 textured cutout", lambda: cutouts.render(
            W, H, samples=spl, max_depth=depth, scene=scene, device=dev),
        ("bf_closest", "bf_any"))
    phase("c4 textured cutout", card=repr(card), dim=f"{W}x{H}", spl=spl,
          depth=depth, ms_per_launch=f"{1e3 * dt:.2f}", rays=int(rays),
          mrays_per_s=f"{int(rays) / dt / 1e6:.1f}",
          unknown_tris=scene.omm_unknown_geom.num_triangles,
          alpha_steps=alpha["steps"],
          image_mean=check_image("c4 textured cutout", accum, (H, W, 3)),
          launches=n, **fields)
    W, H, spl, depth = (CP.TEXTURED_WHITTED[k] for k in (
        "width", "height", "spl", "depth"))
    scene = builtins.textured_whitted_scene(dev)
    cam = builtins.textured_whitted_camera(W, H).params(dev)

    def whitted_one():
        film, r = render_whitted(scene, cam, W, H, 1, max_depth=depth)
        return film.accum, r
    fields = first_sample("c4 textured whitted", whitted_one)
    (film, rays), dt, alpha, _, n = counted(
        "c4 textured whitted", lambda: render_whitted(
            scene, cam, W, H, spl, max_depth=depth), ("bf_closest", "bf_any"))
    phase("c4 textured whitted", card=repr(card), dim=f"{W}x{H}", spl=spl,
          depth=depth, ms_per_sample=f"{1e3 * dt / spl:.2f}", rays=int(rays),
          mrays_per_s=f"{int(rays) / dt / 1e6:.1f}",
          alpha_steps=alpha["steps"],
          image_mean=check_image("c4 textured whitted", film.accum,
                                 (H, W, 3)),
          launches=n, **fields)
    W, H, spl, level = (CP.MICROMESH[k] for k in ("width", "height", "spl",
                                                  "level"))
    fields = first_sample("c4 micromesh", lambda: displaced_micromesh.render(
        W, H, level=level, samples=1, device=dev)[::2])
    (accum, n_tris, rays), dt, _, _, n = counted(
        "c4 micromesh", lambda: displaced_micromesh.render(
            W, H, level=level, samples=spl, device=dev),
        ("bf_closest", "bf_any"))
    require(n_tris == 2 * 4 ** level, "c4: micromesh triangles")
    phase("c4 micromesh", card=repr(card), dim=f"{W}x{H}", spl=spl,
          level=level, triangles=n_tris, ms=f"{1e3 * dt:.2f}",
          rays=int(rays), mrays_per_s=f"{int(rays) / dt / 1e6:.1f}",
          image_mean=check_image("c4 micromesh", accum, (H, W, 3)),
          launches=n, **fields)
    torch.cuda.empty_cache()


def denoise_phases(dev, card, record):
    """Phases n1-n3: the denoiser (the shapes in
    optix_raytracer_tpu_torch/tools/denoise_probe.py). (n1) `pathtracer
    --denoise` at the headline frame as a user runs it (1920x1088, two
    launches of 16 samples, depth 4: kernel 3; render_aovs: kernel 1; the
    trained net's HDR invoke with the emission guide), its counts read on
    that run alone (denoise_launches in the kernels line); then the same
    stages timed one by one, the AOV layers bit-equal to the same call
    through kernel 1's plain version, and a 256x256 crop denoised on the
    card and on the CPU within atol / rtol 1e-3; (n2) the model kinds at
    that frame, 3 calls after a warm-up each, and every invoke case of the
    matrix at 128x96 on the card against the CPU, the flow equal; (n3) the
    reference's quality bars (tests/test_denoise.py:241-310) on 128x128
    renders with variance tracking."""
    import tempfile

    import torch
    from optix_raytracer_tpu_torch import kernels
    from optix_raytracer_tpu_torch.api import Denoiser
    from optix_raytracer_tpu_torch.apps import pathtracer
    from optix_raytracer_tpu_torch.core.film import make_color
    from optix_raytracer_tpu_torch.io.image import load_image
    from optix_raytracer_tpu_torch.scene.builtins import (cornell_box,
                                                         cornell_camera)
    from optix_raytracer_tpu_torch.tools import denoise_probe as DP
    from optix_raytracer_tpu_torch.tools.whitted_probe import plain_queries
    from optix_raytracer_tpu_torch.wavefront.engine import render_aovs

    torch.cuda.init()        # the peak-memory reset needs the context
    names = ("pt_fused_cornell", "bf_closest")
    for name in names:
        record[name]["denoise_launches"] = {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def counted(tag, fn):
        """fn() with every count set to 0 just before and read just after;
        kernels 1 and 3 must have launched (denoise_launches[tag])."""
        torch.cuda.synchronize()
        kernels.reset_launches()
        out, dt = timed(fn)
        n = dict(kernels.LAUNCHES)
        for name in names:
            require(n[name] > 0, f"{tag}: {name} never launched")
            record[name]["denoise_launches"][tag] = n[name]
        return out, dt, {k: n[k] for k in names}

    def events_ms(fn, reps=3):
        """fn() once to warm up, then `reps` calls: (mean ms by CUDA
        events, mean ms by the host clock after a synchronize)."""
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return (start.elapsed_time(end) / reps,
                1e3 * (time.perf_counter() - t0) / reps)

    # --- n1: pathtracer --denoise at the headline frame ---
    W, H, S, spl, depth = (DP.DENOISE[k] for k in ("width", "height",
                                                   "samples", "spl",
                                                   "depth"))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cornell.ppm")
        torch.cuda.reset_peak_memory_stats(dev)
        _, app_s, n = counted("n1", lambda: pathtracer.main(
            ["--file", path, "--dim", f"{W}x{H}", "--samples", str(S),
             "--launch-samples", str(spl), "--depth", str(depth),
             "--denoise", "--device", str(dev)]))
        app_peak = torch.cuda.max_memory_allocated(dev)
        app_img = load_image(path)
    scene, camera = cornell_box(dev), cornell_camera(W, H)
    cam = camera.params(dev)
    (accum, _, rays), render_s = timed(lambda: pathtracer.render(
        W, H, samples=S, max_depth=depth, scene=scene, camera=camera,
        samples_per_launch=spl, device=dev))
    aovs, aov_s = timed(lambda: render_aovs(scene, cam, W, H))
    with plain_queries():
        aovs_p, aov_plain_s = timed(lambda: render_aovs(scene, cam, W, H))
    for k in ("albedo", "normal", "emission"):
        require(aovs[k].shape == (H, W, 3) and torch.equal(aovs[k],
                                                           aovs_p[k]),
                f"n1: the {k} layer through kernel 1 differs from its "
                f"plain version's")
    den = Denoiser(device=dev).setup(W, H)
    g = dict(albedo=aovs["albedo"], normal=aovs["normal"],
             emission=aovs["emission"])
    torch.cuda.reset_peak_memory_stats(dev)
    out, den_first_s = timed(lambda: den.invoke(accum, **g))
    den_peak = torch.cuda.max_memory_allocated(dev)
    den_ms, den_host_ms = events_ms(lambda: den.invoke(accum, **g))
    require(out.shape == (H, W, 3) and bool(torch.isfinite(out).all()),
            "n1: the denoised frame is not finite")
    want = to_np(make_color(out))[..., :3].astype(np.int16)
    require(np.abs(app_img.astype(np.int16) - want).max() <= 1,
            "n1: the app's frame differs from its stages' by more than one "
            "level")
    c = DP.CROP
    y0, x0 = (H - c) // 2, (W - c) // 2

    def crop(t):
        return t[y0:y0 + c, x0:x0 + c]

    gpu = to_np(Denoiser(device=dev).setup(c, c).invoke(
        crop(accum), **{k: crop(v) for k, v in g.items()}))
    cpu = to_np(Denoiser(device="cpu").setup(c, c).invoke(
        crop(accum).cpu(), **{k: crop(v).cpu() for k, v in g.items()}))
    crop_bad = int((np.abs(gpu - cpu) > DP.ATOL + DP.RTOL * np.abs(cpu))
                   .sum())
    require(crop_bad == 0, f"n1: the {c}x{c} crop's card and CPU denoise "
            f"differ in {crop_bad} values (max {np.abs(gpu - cpu).max()})")
    phase("n1 pathtracer --denoise", card=repr(card), dim=f"{W}x{H}",
          samples=S, spl=spl, depth=depth, app_ms=f"{1e3 * app_s:.2f}",
          app_peak_mem_mib=f"{app_peak / 2**20:.0f}", launches=n,
          render_ms=f"{1e3 * render_s:.2f}", rays=int(rays),
          aovs_ms=f"{1e3 * aov_s:.2f}",
          aovs_plain_ms=f"{1e3 * aov_plain_s:.2f}", aovs_bit_equal=True,
          denoise_first_ms=f"{1e3 * den_first_s:.2f}",
          denoise_ms_events=f"{den_ms:.3f}",
          denoise_ms_host=f"{den_host_ms:.3f}",
          denoise_peak_mem_mib=f"{den_peak / 2**20:.0f}",
          crop=f"{c}x{c}", crop_max_abs_err=f"{np.abs(gpu - cpu).max():.3g}",
          image_mean=f"{float(out.mean()):.5f}",
          noisy_mean=f"{float(accum.mean()):.5f}")

    # --- n2: the model kinds at the headline frame, and the matrix ---
    x = DP.headline_inputs(accum, aovs)
    kinds = {}
    for name, fn in DP.kind_calls(x, dev).items():
        torch.cuda.reset_peak_memory_stats(dev)
        ev, host = events_ms(fn)
        res = fn()
        res = res[0] if isinstance(res, tuple) else res
        require(bool(torch.isfinite(res).all()), f"n2 {name}: not finite")
        kinds[name] = dict(ms_events=round(ev, 3), ms_host=round(host, 3),
                           peak_mib=round(torch.cuda.max_memory_allocated(
                               dev) / 2**20))
    phase("n2 model kinds", card=repr(card), dim=f"{W}x{H}",
          kinds=json.dumps(kinds))
    t0 = time.perf_counter()
    errs = DP.matrix_parity(dev)
    phase("n2 card vs cpu", cases=len(errs), flow_equal=True,
          max_abs_err=f"{max(errs.values()):.3g}",
          seconds=f"{time.perf_counter() - t0:.1f}",
          per_case=json.dumps({k: float(f"{v:.3g}")
                               for k, v in errs.items()}))
    del x, accum, aovs, aovs_p, out
    torch.cuda.empty_cache()

    # --- n3: the reference's quality bars ---
    q = DP.QUALITY
    s, depth = q["size"], q["depth"]

    def quality():
        clean = DP.tracked_render(*q["clean"], s, depth, dev).accum
        aq = render_aovs(cornell_box(dev), cornell_camera(s, s).params(dev),
                         s, s)
        out = {}
        for key in ("open", "converged"):
            film = DP.tracked_render(*q[key], s, depth, dev)
            res = Denoiser(device=dev).setup(s, s).invoke(
                film.accum, albedo=aq["albedo"], normal=aq["normal"],
                emission=aq["emission"], variance=film.variance_of_mean())
            out[key] = (DP.log_mse(film.accum, clean),
                        DP.log_mse(res, clean))
        return out

    lm, q_s, n = counted("n3", quality)
    require(lm["open"][1] < 0.8 * lm["open"][0],
            f"n3: the gated 4-spp output's log-MSE {lm['open'][1]:.4g} is "
            f"not below 0.8x the noisy input's {lm['open'][0]:.4g}")
    require(lm["converged"][1] <= 1.001 * lm["converged"][0],
            f"n3: the gated 64-spp output's log-MSE "
            f"{lm['converged'][1]:.4g} exceeds 1.001x the noisy input's "
            f"{lm['converged'][0]:.4g}")
    phase("n3 quality bars", card=repr(card), dim=f"{s}x{s}",
          seconds=f"{q_s:.2f}", launches=n,
          spp4_log_mse=f"{lm['open'][0]:.6g}->{lm['open'][1]:.6g}",
          spp64_log_mse=f"{lm['converged'][0]:.6g}->"
                        f"{lm['converged'][1]:.6g}")
    torch.cuda.empty_cache()


def mcv_phases(dev, card, record):
    """Phases v1-v3: motion blur, curves and volumes through their six apps
    at the apps' default frames (the shapes in
    optix_raytracer_tpu_torch/tools/mcv_probe.py), each run's launches of
    kernels 1-2 counted on it alone (v_launches in the kernels line), its
    ms a sample by the host clock after a synchronize, and its peak memory.
    (v1) `simple_motion_blur --engine` (512x512, 32 samples, depth 2: the
    moving triangle through the main path tracer, the floor's queries on
    kernels 1-2), its standalone renderer and `motion_geometry` (512x512,
    32 samples: the SRT-keyed blades' object-space rays on kernel 1); each
    first sample's recorded queries through the kernels bit-equal to their
    plain versions, and its image bit-equal to the one rendered through
    the plain versions (whitted_probe.plain_queries). (v2) `curves` (the
    cubic B-spline strand as capsules and as swept spans) and `ribbons`
    (512x512, 8 samples, depth 2, through the Whitted integrator: kernels
    1-2 on the placeholder mesh, the prims by torch ops) and `hair` (the
    procedural fur as swept cubic spans, 512x512, 4 samples); kernel 1's
    answers on the placeholder mesh bit-equal to its plain version, and
    each first sample's 64x64 centre crop within the bars of the port's
    CPU output on the same rays (the card's camera rays, MP.crop_rays).
    (v3) `volume_viewer` standalone (512x512,
    4 samples, the puffball at res 64, 96 steps), its crop held against the
    CPU's march; the NanoVDB path on a grid this phase writes (read back
    equal, then marched); and `--engine` (512x512, 4 samples, res 48, depth
    3: the cloud in the Cornell box, kernels 1-2 answering the closest, NEE
    and scatter shadow queries), its first sample bit-equal through the
    plain versions."""
    import tempfile

    import torch
    from optix_raytracer_tpu_torch import kernels
    from optix_raytracer_tpu_torch.apps import curves as curves_app
    from optix_raytracer_tpu_torch.apps import hair as hair_app
    from optix_raytracer_tpu_torch.apps import motion_geometry as mg_app
    from optix_raytracer_tpu_torch.apps import ribbons as ribbons_app
    from optix_raytracer_tpu_torch.apps import simple_motion_blur as smb
    from optix_raytracer_tpu_torch.apps import volume_viewer as vv
    from optix_raytracer_tpu_torch.core.film import Film
    from optix_raytracer_tpu_torch.io import nanovdb
    from optix_raytracer_tpu_torch.scene.builtins import cornell_camera
    from optix_raytracer_tpu_torch.tools import mcv_probe as MP
    from optix_raytracer_tpu_torch.tools.whitted_probe import (
        plain_queries, recorded_queries)
    from optix_raytracer_tpu_torch.wavefront.engine import render_accumulate
    from optix_raytracer_tpu_torch.wavefront.whitted import trace_whitted

    torch.cuda.init()
    names = ("bf_closest", "bf_any")
    for name in names:
        record[name]["v_launches"] = {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def counted(tag, fn, need=names):
        """fn() with every count set to 0 just before and read just after,
        and its peak memory; the kernels in `need` must have launched
        (v_launches[tag])."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        out, dt = timed(fn)
        n = dict(kernels.LAUNCHES)
        for name in need:
            require(n[name] > 0, f"{tag}: {name} never launched")
        for name in names:
            record[name]["v_launches"][tag] = n[name]
        peak = torch.cuda.max_memory_allocated(dev)
        return out, dt, {k: n[k] for k in names}, f"{peak / 2**20:.0f}"

    def first_sample(tag, fn):
        """fn() (one sample, → an [H, W, 3] tensor or a tuple led by one)
        with its brute-force queries recorded, each held kernel against
        plain version; then again through the plain versions, bit-equal →
        (image numpy, queries checked)."""
        with recorded_queries() as calls:
            out = fn()
        for call in calls:
            r = MP.bf_query_parity(call)
            require(r["bit_equal"], f"{tag}: a {r['kind']} query through "
                    f"its kernel differs from the plain version ({r})")
        with plain_queries():
            ref = fn()
        a = to_np(out[0] if isinstance(out, tuple) else out)
        b = to_np(ref[0] if isinstance(ref, tuple) else ref)
        require(np.array_equal(a, b), f"{tag}: the first sample through "
                f"kernels 1-2 differs from the plain versions' by "
                f"{np.abs(a - b).max()}")
        require(np.isfinite(a).all(), f"{tag}: the first sample is not "
                "finite")
        return a, len(calls)

    def check_image(tag, img, w, h):
        img = to_np(img)
        require(img.shape == (h, w, 3) and np.isfinite(img).all()
                and (img >= 0).all() and img.mean() > 0,
                f"{tag}: the image is not finite, negative or black")
        return f"{img.mean():.5f}"

    # --- v1: motion ---
    c = MP.MOTION_BLUR
    W, H, spl, depth = c["width"], c["height"], c["spl"], c["depth"]
    scene = smb.engine_scene(dev)
    cam = smb.engine_camera(W, H).params(dev)
    first, queries = first_sample("v1 motion blur --engine", lambda: (
        render_accumulate(scene, cam, Film.create(H, W, dev), W, H,
                          samples_per_launch=1, max_depth=depth,
                          chunk_size=None)[0].accum))
    (accum, film, rays), dt, n, peak = counted(
        "v1_motion_blur_engine", lambda: smb.render_engine(
            W, H, spl, max_depth=depth, device=dev))
    phase("v1 motion blur --engine", card=repr(card), dim=f"{W}x{H}",
          spl=spl, depth=depth, ms_per_sample=f"{1e3 * dt / spl:.3f}",
          peak_mem_mib=peak, launches=n, rays=int(rays),
          first_sample_queries=queries, first_sample_bit_equal=True,
          image_mean=check_image("v1 engine", accum, W, H))
    (accum, film), dt, n, peak = counted(
        "v1_motion_blur", lambda: smb.render(W, H, samples=spl, device=dev),
        need=())
    phase("v1 motion blur standalone", card=repr(card), dim=f"{W}x{H}",
          spl=spl, ms_per_sample=f"{1e3 * dt / spl:.3f}", peak_mem_mib=peak,
          launches=n, image_mean=check_image("v1 standalone", accum, W, H))
    c = MP.MOTION_GEOMETRY
    W, H, spl = c["width"], c["height"], c["spl"]
    first, queries = first_sample("v1 motion_geometry", lambda: mg_app.render(
        W, H, samples=1, device=dev)[0])
    (accum, film), dt, n, peak = counted(
        "v1_motion_geometry", lambda: mg_app.render(W, H, samples=spl,
                                                    device=dev),
        need=("bf_closest",))
    phase("v1 motion_geometry", card=repr(card), dim=f"{W}x{H}", spl=spl,
          ms_per_sample=f"{1e3 * dt / spl:.3f}", peak_mem_mib=peak,
          launches=n, first_sample_queries=queries,
          first_sample_bit_equal=True,
          image_mean=check_image("v1 motion_geometry", accum, W, H))
    del scene, accum, film
    torch.cuda.empty_cache()

    # --- v2: curves ---
    def whitted_crop(scene_cpu, camera, w, h, depth):
        rays, rng = MP.crop_rays(camera.params(dev), w, h, 0)
        rad, _, _ = trace_whitted(scene_cpu, rays, rng, max_depth=depth)
        return to_np(rad)

    c = MP.CURVES
    W, H, spl, depth = c["width"], c["height"], c["spl"], c["depth"]
    for swept in (False, True):
        tag = f"v2_curves{'_swept' if swept else ''}"
        scene = curves_app.make_curve_scene(dev, c["kind"], swept=swept)
        first, queries = first_sample(tag, lambda: curves_app.render(
            W, H, samples=1, scene=scene))
        bad, err = MP.outside_bar(
            MP.crop(first), whitted_crop(curves_app.make_curve_scene(
                "cpu", c["kind"], swept=swept), curves_app.camera(W, H), W, H,
                depth), MP.ATOL_PRIMS)
        require(bad == 0, f"{tag}: {bad} pixels of the {MP.CROP}² crop "
                f"outside the bar of the CPU's (max {err:.3g})")
        (accum, film, rays), dt, n, peak = counted(tag, lambda: (
            curves_app.render(W, H, samples=spl, scene=scene)))
        phase(f"v2 curves {c['kind']}{' --swept' if swept else ''}",
              card=repr(card), dim=f"{W}x{H}", spl=spl, depth=depth,
              prims=scene.prims.num, ms_per_sample=f"{1e3 * dt / spl:.3f}",
              peak_mem_mib=peak, launches=n, rays=int(rays),
              first_sample_queries=queries, kernel1_bit_equal=True,
              crop_outside_bar=bad, crop_max_abs_err=f"{err:.3g}",
              image_mean=check_image(tag, accum, W, H))
    c = MP.RIBBONS
    W, H, spl, depth = c["width"], c["height"], c["spl"], c["depth"]
    scene = ribbons_app.make_ribbon_scene(dev)
    first, queries = first_sample("v2 ribbons", lambda: ribbons_app.render(
        W, H, samples=1, scene=scene))
    bad, err = MP.outside_bar(
        MP.crop(first), whitted_crop(ribbons_app.make_ribbon_scene("cpu"),
                                     ribbons_app.camera(W, H), W, H, depth),
        MP.ATOL_PRIMS)
    require(bad == 0, f"v2 ribbons: {bad} pixels of the crop outside the "
            f"bar of the CPU's (max {err:.3g})")
    (accum, film, rays), dt, n, peak = counted("v2_ribbons", lambda: (
        ribbons_app.render(W, H, samples=spl, scene=scene)))
    phase("v2 ribbons", card=repr(card), dim=f"{W}x{H}", spl=spl,
          depth=depth, prims=scene.prims.num,
          ms_per_sample=f"{1e3 * dt / spl:.3f}", peak_mem_mib=peak,
          launches=n, rays=int(rays), first_sample_queries=queries,
          kernel1_bit_equal=True, crop_outside_bar=bad,
          crop_max_abs_err=f"{err:.3g}",
          image_mean=check_image("v2 ribbons", accum, W, H))
    c = MP.HAIR
    W, H, spl = c["width"], c["height"], c["spl"]
    kw = dict(spline=c["spline"], swept=c["swept"])
    (first, _), first_s = timed(lambda: hair_app.render(
        W, H, samples=1, device=dev, **kw))
    strands, radii = hair_app.procedural_fur()
    prims, strand_of = hair_app.build_prims(strands, radii, "cpu", **kw)
    rays, _ = MP.crop_rays(hair_app.camera(W, H).params(dev), W, H, 0)
    bad, err = MP.outside_bar(MP.crop(to_np(first)), to_np(
        hair_app.sample_radiance(prims, strand_of, "strand_u", rays)),
        MP.ATOL_PRIMS)
    require(bad == 0, f"v2 hair: {bad} pixels of the crop outside the bar "
            f"of the CPU's (max {err:.3g})")
    (accum, film), dt, n, peak = counted("v2_hair", lambda: hair_app.render(
        W, H, samples=spl, device=dev, **kw), need=())
    phase("v2 hair --swept --spline cubic_bspline", card=repr(card),
          dim=f"{W}x{H}", spl=spl, prims=prims.num,
          plane_elems=hair_app.prim.PLANE_ELEMS,
          ms_per_sample=f"{1e3 * dt / spl:.3f}",
          first_sample_ms=f"{1e3 * first_s:.3f}", peak_mem_mib=peak,
          launches=n, crop_outside_bar=bad, crop_max_abs_err=f"{err:.3g}",
          image_mean=check_image("v2 hair", accum, W, H))
    del scene, accum, film, prims
    torch.cuda.empty_cache()

    # --- v3: volumes ---
    c = MP.VOLUME
    W, H, spl, res, steps = (c[k] for k in ("width", "height", "spl", "res",
                                           "steps"))
    (first, _), first_s = timed(lambda: vv.render(
        W, H, samples=1, res=res, num_steps=steps, device=dev))
    rays, _ = MP.crop_rays(vv.camera(W, H).params(dev), W, H, 0)
    bad, err = MP.outside_bar(MP.crop(to_np(first)), to_np(vv.march_rays(
        vv.load_grid(None, res=res, device="cpu"), vv.floor("cpu"), rays,
        steps)), MP.ATOL)
    require(bad == 0, f"v3 volume_viewer: {bad} pixels of the crop outside "
            f"the bar of the CPU's march (max {err:.3g})")
    (accum, film), dt, n, peak = counted("v3_volume_viewer", lambda: (
        vv.render(W, H, samples=spl, res=res, num_steps=steps, device=dev)),
        need=())
    phase("v3 volume_viewer", card=repr(card), dim=f"{W}x{H}", spl=spl,
          res=res, steps=steps, ms_per_sample=f"{1e3 * dt / spl:.3f}",
          first_sample_ms=f"{1e3 * first_s:.3f}", peak_mem_mib=peak,
          launches=n, crop_outside_bar=bad, crop_max_abs_err=f"{err:.3g}",
          image_mean=check_image("v3 volume_viewer", accum, W, H))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cloud.nvdb")
        dens = to_np(vv.load_grid(None, res=res, device="cpu").density)
        nanovdb.write_nvdb(path, dens, ijk_min=(-32, 8, 0), voxel_size=0.05,
                           codec=nanovdb.CODEC_ZIP)
        g = nanovdb.read_nvdb(path)
        o = g.ijk_min - np.array([-32, 8, 0])
        require(np.array_equal(g.values, dens[o[2]:o[2] + g.values.shape[0],
                                              o[1]:o[1] + g.values.shape[1],
                                              o[0]:o[0] + g.values.shape[2]])
                and (dens[:o[2]] == 0).all(),
                "v3 nanovdb: the grid read back differs from the grid "
                "written")
        (accum, film), dt, n, peak = counted("v3_volume_viewer_nvdb", lambda: (
            vv.render(W, H, samples=1, num_steps=steps, grid_file=path,
                      device=dev)), need=())
    phase("v3 volume_viewer --grid", card=repr(card), dim=f"{W}x{H}",
          grid=list(g.values.shape), read_back_equal=True,
          ms_per_sample=f"{1e3 * dt:.3f}", peak_mem_mib=peak, launches=n,
          image_mean=check_image("v3 nvdb", accum, W, H))
    c = MP.VOLUME_ENGINE
    W, H, spl, res, depth = (c[k] for k in ("width", "height", "spl", "res",
                                           "depth"))
    scene = vv.engine_scene(dev, res)
    cam = cornell_camera(W, H).params(dev)
    first, queries = first_sample("v3 volume_viewer --engine", lambda: (
        render_accumulate(scene, cam, Film.create(H, W, dev), W, H,
                          samples_per_launch=1, max_depth=depth,
                          chunk_size=None)[0].accum))
    (accum, film, rays), dt, n, peak = counted(
        "v3_volume_viewer_engine", lambda: vv.render_engine(
            W, H, spl, res=res, max_depth=depth, device=dev))
    phase("v3 volume_viewer --engine", card=repr(card), dim=f"{W}x{H}",
          spl=spl, res=res, depth=depth,
          ms_per_sample=f"{1e3 * dt / spl:.3f}", peak_mem_mib=peak,
          launches=n, rays=int(rays), first_sample_queries=queries,
          first_sample_bit_equal=True,
          image_mean=check_image("v3 engine", accum, W, H))
    del scene, accum, film
    torch.cuda.empty_cache()


def api_phases(dev, card, record):
    """Phases a1-a3 (optix_raytracer_tpu_torch/tools/api_probe.py): (a1) the
    host API's validation-mode Pipeline.launch of the Cornell box at the
    headline (the fused kernel), the Whitted scene (768x576, 4 samples a
    launch, depth 6; kernels 1-2) and the 25k knot at the knot headline
    (kernels 4-6), each assembled from a GAS and SBT records, bit-equal to
    the direct render on the assembled scene with equal ray counts and zero
    exception counters, ms a launch; (a2) the knot past the cluster cap
    (4,260,002 triangles): build_gas's LBVH on the card timed beside the
    native SAH build, one launch at 1920x1088, depth 3, through the walk
    kernel and no cluster kernel, and the walk kernel timed on the camera
    and shadow rays, bit-equal to the lock-step loop on the same rays;
    (a3) the six apps at their defaults through main(), writing into the
    git-ignored _build/apps → the walk kernels' launch counts on a2's
    launch."""
    import torch
    from optix_raytracer_tpu_torch.tools import api_probe as AP
    t_start = time.perf_counter()
    # --- a1: three launches through the API ---
    for name, case in AP.api_cases(dev).items():
        r = AP.pipeline_case(case, dev)
        phase(f"a1 pipeline {name}", card=repr(card), **fmt(r))
        torch.cuda.empty_cache()
    # --- a2: the knot past the cluster cap through the walk kernel ---
    r = AP.past_cap_case(dev, record)
    phase("a2 knot past the cap", card=repr(card), **fmt(r))
    for name in ("bvh_walk_closest", "bvh_walk_any"):
        phase(f"a2 {name}", card=repr(card), **fmt(record[name]))
    counts = {n: r["launches"].get(n, 0) for n in ("bvh_walk_closest",
                                                   "bvh_walk_any")}
    torch.cuda.empty_cache()
    # --- a3: the six apps at their default sizes ---
    for row in AP.run_apps(os.path.join(ROOT, "optix_raytracer_tpu_torch",
                                        "_build", "apps"), dev):
        phase(f"a3 {row['app']} {row['args']}".strip(), card=repr(card),
              **fmt(row))
    phase("a total", seconds=f"{time.perf_counter() - t_start:.1f}")
    return counts


def model_phases(dev, card, record):
    """Phases s1-s4 (optix_raytracer_tpu_torch/tools/model_probe.py), each
    row with ms a sample or frame, torch kernels a sample or frame and the
    device's idle share: (s1) the knot model written as .glb and OBJ, the
    OBJ through the native parser, the .glb through the meshviewer's render
    (its first sample's nine cluster queries against the plain versions,
    the image bit-equal to the arrays added through Scene.add_mesh /
    add_texture), `--model` and `--animate 3` through main(); (s2) the
    viewer's headless defaults (8 frames of the Cornell box, kernel 3) with
    its film bit-equal to the same render_accumulate launches and to a
    --checkpoint / --resume split, then 4 --model frames of the .glb; (s3)
    four instances of the 25k knot through the meshviewer's rig and one
    path-traced launch of 16 spp, against the same meshes baked flat; (s4)
    the six small apps at their CLI defaults → each kernel's launches on
    the phases' main runs (also kept per phase in the record as
    s_launches)."""
    import torch
    from optix_raytracer_tpu_torch.tools import model_probe as MP
    out_dir = os.path.join(ROOT, "optix_raytracer_tpu_torch", "_build",
                           "models")
    t_start = time.perf_counter()
    per_phase = {}
    # --- s1: a loaded model through the meshviewer ---
    row, per_phase["s1"] = MP.loaded_model_case(
        dev, out_dir, query_check=whitted_query_parity)
    phase("s1 meshviewer --model", card=repr(card),
          launches=per_phase["s1"], **fmt(row))
    for name in ("cluster_cull_exact", "cluster_closest", "cluster_any"):
        require(per_phase["s1"].get(name, 0) > 0,
                f"s1: {name} never launched on the loaded model")
    torch.cuda.empty_cache()
    glb = os.path.join(out_dir, "knot.glb")
    # --- s2: the viewer ---
    row, per_phase["s2"], per_phase["s2 model"] = MP.viewer_case(dev,
                                                                 out_dir, glb)
    phase("s2 viewer", card=repr(card), launches=per_phase["s2"],
          model_launches=per_phase["s2 model"], **fmt(row))
    require(per_phase["s2"].get("pt_fused_cornell", 0) > 0,
            "s2: the viewer's Cornell frames never launched kernel 3")
    require(per_phase["s2 model"].get("cluster_closest", 0) > 0,
            "s2: the viewer's --model frames never launched kernel 5")
    torch.cuda.empty_cache()
    # --- s3: instanced meshes past 512 triangles ---
    row, per_phase["s3"], per_phase["s3 pt"] = MP.instanced_case(
        dev, query_check=whitted_query_parity)
    phase("s3 instanced knots", card=repr(card), launches=per_phase["s3"],
          pt_launches=per_phase["s3 pt"], **fmt(row))
    for key in ("s3", "s3 pt"):
        for name in ("cluster_cull_exact", "cluster_closest",
                     "cluster_any"):
            require(per_phase[key].get(name, 0) > 0,
                    f"{key}: {name} never launched on the instances")
        require(not any(k.startswith("pt_fused") for k in per_phase[key]),
                f"{key}: the fused kernel ran on a range past its budget")
    # The walk is not bit-equal to the flat bake's: object-space rays (the
    # instance's inverse applied) round apart from world-space ones, so a
    # ray grazing a silhouette edge can hit on one side and miss on the
    # other. A pixel it passes through leaves the bars; at most 0.1% may,
    # and the ray counts agree to 1e-4.
    pixels = 768 * 768
    require(row["pixels_outside_bars"] <= 1e-3 * pixels
            and row["pt_pixels_outside_bars"] <= 1e-3 * pixels
            and abs(row["rays"] - row["flat_rays"]) <= 1e-4 * row["rays"]
            and abs(row["pt_rays"] - row["pt_flat_rays"])
            <= 1e-4 * row["pt_rays"],
            f"s3: the instanced images leave the parity bars of the flat "
            f"bake on {row['pixels_outside_bars']} / "
            f"{row['pt_pixels_outside_bars']} pixels, or the ray counts "
            f"differ")
    torch.cuda.empty_cache()
    # --- s4: the small apps ---
    for r in MP.small_apps_case(dev, out_dir, glb):
        per_phase[f"s4 {r['app']}"] = r.pop("launches")
        phase(f"s4 {r['app']}", card=repr(card),
              launches=per_phase[f"s4 {r['app']}"], **fmt(r))
    require(per_phase["s4 triangle"].get("bf_closest", 0) > 0
            and per_phase["s4 console"].get("pt_fused_cornell", 0) > 0
            and per_phase["s4 raycasting --model"].get("cluster_closest", 0)
            > 0, "s4: an app never launched its kernel")
    totals = {}
    for key, counts in per_phase.items():
        for name, n in counts.items():
            totals[name] = totals.get(name, 0) + n
            record.setdefault(name, {}).setdefault("s_launches", {})[key] = n
    phase("s total", seconds=f"{time.perf_counter() - t_start:.1f}",
          launches=totals)
    return totals


def multichip_phases(dev, card, record):
    """Phases p1-p4 (optix_raytracer_tpu_torch/tools/multichip_probe.py):
    (p1) four ranks on this card (gloo: they share it; with four cards
    NCCL, one each) render the Cornell headline (1920x1088, 16 samples a
    launch, depth 4) as 2 rows x 2 samples (twice: progressive), 4
    interleaved rows and 2 slices x 2 rows, each gathered frame within
    rtol and atol 1e-5 of the single-process wavefront launch (kernels 1-2,
    as in the ranks) with the same rays, every rank's frame equal and every
    rank launching kernels 1-2, no collective crossing the slice axis
    before the gather; ms a launch on one rank (a 1 x 1 mesh here) and on
    four, and the gather's ms; four ranks sharing one card measure the
    layer's overhead, not its scaling. (p2) the nvlink app's rank body
    with --check at a 1 MB budget: shard_island over the 4 ranks, bytes at
    rest a quarter of the stacks' (plus row padding), the placed render
    bit-equal to the whole stacks' on every rank; the same scene
    shard_global over 2 slices x 2 rows and its atlas alone over rows,
    bit-equal too. (p3) a sharded checkpoint of a 512x512 film written by
    the 4 ranks, loaded whole here and by 2 ranks of a 2-row split, each
    resume bit-equal to the straight run. (p4) train_denoiser's dataset
    (two scenes at RES 256, clean 1024 spp; kernel 3 renders, kernel 1
    answers render_aovs) and 10 Adam steps at batch 8 on 128^2 patches:
    finite losses, the first step's loss, gradients and parameters against
    the CPU's from the same parameters and batch within the denoiser's bars
    (TF32 off). → each kernel's launches on these paths."""
    import torch
    from optix_raytracer_tpu_torch.core import checkpoint
    from optix_raytracer_tpu_torch.multichip import distributed, tiles
    from optix_raytracer_tpu_torch.scene.builtins import (cornell_box,
                                                         cornell_camera)
    from optix_raytracer_tpu_torch.tools import multichip_probe as MC
    from optix_raytracer_tpu_torch.wavefront.engine import render_accumulate
    W, H, spl, depth = (P_TILES[k] for k in ("width", "height", "spl",
                                             "depth"))
    t_start = time.perf_counter()
    work = os.path.join(ROOT, "optix_raytracer_tpu_torch", "_build",
                        "multichip")
    os.makedirs(work, exist_ok=True)
    ck = dict(P_CKPT, depth=depth, path=os.path.join(work, "film_ckpt"))
    cfg = dict(tiles=dict(w=W, h=H, spl=spl, depth=depth, shapes=dict(
                   sharded=(2, 2), interleaved=4, multislice=(2, 2, 1))),
               nvlink=P_NVLINK, checkpoint=ck)
    # single-process references: the wavefront launch (kernels 1-2, as in
    # the ranks) and its continuation, and one rank's launch (a 1 x 1 mesh)
    scene = cornell_box(dev)
    cam = cornell_camera(W, H).params(dev)
    from optix_raytracer_tpu_torch.core.film import Film
    ref1, ref_rays = render_accumulate(scene, cam, Film.create(H, W, dev), W,
                                       H, spl, depth, impl="wavefront")
    ref2, ref2_rays = render_accumulate(scene, cam, ref1, W, H, spl, depth,
                                        impl="wavefront")
    ref1_np, ref2_np = to_np(ref1.accum), to_np(ref2.accum)
    one = tiles.make_mesh(1, 1, device=dev)
    (_, one_rays), one_ms, _ = MC._timed(one, lambda: (
        tiles.render_accumulate_sharded(
            scene, cam, tiles.shard_film(Film.create(H, W, dev), one), one,
            W, H, samples_per_launch=spl, max_depth=depth)))
    require(int(one_rays) == int(ref_rays),
            "p1: the 1 x 1 mesh's rays differ from the single launch's")
    t0 = time.perf_counter()
    ranks = distributed.launch_local(MC.rank_phases, 4, cfg,
                                     device=dev.type, timeout=900)
    ranks_s = time.perf_counter() - t0
    totals = {}

    def add(counts):
        for name, n in counts.items():
            totals[name] = totals.get(name, 0) + n

    # --- p1: tiles ---
    for layout in ("sharded", "sharded_2", "interleaved", "multislice"):
        rows = [r["p1"][layout] for r in ranks]
        r0 = rows[0]
        require(len({(r["digest"], r["subframe"], r["rays"]) for r in rows})
                == 1, f"p1 {layout}: the ranks' gathered frames differ")
        ref, want_rays = ((ref2_np, int(ref2_rays)) if layout == "sharded_2"
                          else (ref1_np, int(ref_rays)))
        accum = r0["accum"]
        if layout == "interleaved":
            accum = tiles.deinterleave_rows(accum, 4)
        err = float(np.abs(accum - ref).max())
        require(np.allclose(accum, ref, rtol=1e-5, atol=1e-5),
                f"p1 {layout}: {err} from the single-process frame")
        require(r0["subframe"] == spl * (2 if layout == "sharded_2" else 1),
                f"p1 {layout}: subframe {r0['subframe']}")
        require(r0["rays"] == want_rays,
                f"p1 {layout}: rays {r0['rays']} != {want_rays}")
        for i, r in enumerate(rows):
            require(r["launches"].get("bf_closest", 0) > 0
                    and r["launches"].get("bf_any", 0) > 0,
                    f"p1 {layout}: rank {i} never launched kernels 1-2")
            add(r["launches"])
        phase(f"p1 tiles {layout}", card=repr(card), dim=f"{W}x{H}",
              spl=spl, depth=depth, ranks=4, backend="gloo (one card)",
              max_abs_err=err, rays=r0["rays"],
              ms_per_launch_4_ranks=f"{max(r['wall_ms'] for r in rows):.2f}",
              rank_ms=[round(r["ms"], 2) for r in rows],
              gather_ms=f"{max(r['gather_ms'] for r in rows):.2f}",
              launches=[r["launches"] for r in rows])
    render_log, after, grid = ranks[0]["p1"]["multislice_log"]
    slices = [set(np.ravel(g).tolist()) for g in grid]
    require(all(any(set(m) <= sl for sl in slices)
                for _, _, m in render_log),
            f"p1: a render-time collective crossed the slice axis: "
            f"{render_log}")
    phase("p1 one rank", card=repr(card), ms_per_launch=f"{one_ms:.2f}",
          rays=int(one_rays), ranks_wall_s=f"{ranks_s:.1f}",
          note="four ranks share one card: the layer's overhead, not "
               "scaling")
    # --- p2: nvlink --check ---
    for key, mode in (("rows", "shard_island"), ("slices", "shard_global"),
                      ("atlas_rows", None)):
        for i, r in enumerate(ranks):
            rep = r["p2"][key]
            require(rep["bit_equal"], f"p2 {key}: rank {i}'s placed render "
                                      f"differs from the whole stacks'")
            require(mode is None or rep["mode"] == mode,
                    f"p2 {key}: mode {rep.get('mode')} != {mode}")
        rep = ranks[0]["p2"][key]
        phase(f"p2 nvlink {key}", card=repr(card), mode=rep.get("mode"),
              per_rank_bytes=rep["per_chip_bytes_measured"],
              stacks_bytes=rep.get("total_bytes"), bit_equal=True)
    rep = ranks[0]["p2"]["rows"]
    per, whole = rep["per_chip_bytes_measured"], rep["replicated_bytes"]
    require(whole <= 4 * per <= 1.01 * whole,
            f"p2: {per} bytes at rest a rank, not a quarter of {whole}")
    for r in ranks:
        add(r["p2"]["rows"]["launches"])
    require(any(k.startswith("pt_fused_tex") for k in
                ranks[0]["p2"]["rows"]["launches"]),
            "p2: the placed render never launched the fused texture kernel")
    phase("p2 bytes at rest", card=repr(card), per_rank=per,
          replicated=whole, drop=f"{whole / per:.3f}x",
          launches=ranks[0]["p2"]["rows"]["launches"])
    # --- p3: checkpoint ---
    first, _, first_sub = ranks[0]["p3"]["first"]
    film, _, config = checkpoint.load_checkpoint_sharded(ck["path"], dev)
    require(np.array_equal(to_np(film.accum), first)
            and int(film.subframe) == first_sub
            and config == {"spl": ck["spl"]},
            "p3: the checkpoint loaded in one process is not the film")
    half = ck["h"] // 2
    for i in (0, 1):
        band, sub = ranks[i]["p3"]["loaded_band"]
        require(np.array_equal(band, first[i * half:(i + 1) * half])
                and sub == first_sub, f"p3: rank {i}'s loaded rows differ")
        require(ranks[i]["p3"]["resumed"][1:] == ranks[i]["p3"]["straight"][
            1:], f"p3: rank {i}'s resume differs from the straight run")
    cw, ch = ck["w"], ck["h"]
    ck_cam = cornell_camera(cw, ch).params(dev)
    resumed, _ = tiles.render_accumulate_sharded(
        scene, ck_cam, film, one, cw, ch, samples_per_launch=ck["spl"],
        max_depth=depth)
    straight, _ = tiles.render_accumulate_sharded(
        scene, ck_cam, Film(accum=torch.as_tensor(first, device=dev),
                            subframe=torch.tensor(first_sub, device=dev)),
        one, cw, ch, samples_per_launch=ck["spl"], max_depth=depth)
    require(torch.equal(resumed.accum, straight.accum),
            "p3: the one-process resume differs from the straight run")
    phase("p3 checkpoint", card=repr(card), dim=f"{cw}x{ch}",
          save_ms=f"{max(r['p3']['save_ms'] for r in ranks):.1f}",
          load_ms_2_ranks=f"{ranks[0]['p3']['load_ms']:.1f}",
          resume_bit_equal=True)
    # --- p4: training ---
    data = os.path.join(work, "denoiser_data")
    import shutil
    shutil.rmtree(data, ignore_errors=True)
    tr = MC.training_case(dev, data, **P_TRAIN)
    require(np.isfinite(tr["losses"]).all(), f"p4: losses {tr['losses']}")
    require(abs(tr["losses"][0] - tr["loss_cpu"])
            <= 1e-4 + 1e-3 * abs(tr["loss_cpu"]),
            f"p4: first loss {tr['losses'][0]} vs the CPU's "
            f"{tr['loss_cpu']}")
    require(tr["grad_outside_bars"] == 0 and tr["params_outside_bars"] == 0,
            f"p4: {tr['grad_outside_bars']} gradient and "
            f"{tr['params_outside_bars']} parameter elements outside the "
            f"bars of the CPU's first step")
    require(any(k.startswith("pt_fused") for k in tr["launches"])
            and tr["launches"].get("bf_closest", 0) > 0,
            f"p4: the dataset renders launched {tr['launches']}")
    add(tr["launches"])
    phase("p4 training", card=repr(card), scenes=2, **P_TRAIN,
          ms_per_scene=f"{tr['scene_ms']:.1f}",
          ms_per_step=f"{tr['step_ms']:.2f}",
          losses=[round(x, 5) for x in tr["losses"]],
          loss_cpu=tr["loss_cpu"], open_sign_params=tr["open_sign_params"],
          launches=tr["launches"])
    for name, n in totals.items():
        record.setdefault(name, {})["p_launches"] = n
    phase("p total", seconds=f"{time.perf_counter() - t_start:.1f}",
          launches=totals)
    return totals


def sc_phases(dev, card, record):
    """Phases (e)-(g): the 4.0M-triangle knot through the supercluster tier.
    (e) the build, timed per step, and traversal_stats at supercluster
    granularity; (f) kernels 5c/6c (and kernel 4 on the supercluster facade)
    against their plain versions on tile-ordered primaries (interval cull),
    NEE shadow rays (exact cull) and the four cluster queries of one
    sample-major strip of the main path to depth 2 (rows and occlusion bit-equal on
    the plain walks' block subset; both kernels timed on all blocks; the
    set's pair tests at the block, warp and ray granularity, under the
    admission rule and needed; the dropped-pair audit, sc_audit), plus the
    primaries' closest-hit query rate (bench.py:346-384); (g) the 4M
    launch, sample-major against the sequential oracle, launches counted
    per path. Returns the sample-major path's counts of kernels 5c/6c."""
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
    # The strip is recorded to depth 2 (bounces 0-1, whose bounce-1 sets
    # give the record's times), not the launch's 3: its bounce-2 sets took
    # ~41 s of the run on the 4M tier and held the same kernels to the
    # same plain walks as bounce 1 (phase g still launches at depth 3).
    closest_calls, any_calls = main_path_strip_sets(scene, cam, W, H, spl,
                                                    min(depth, 2))
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
        **b1["closest_bound"], plain_blocks=b1["walk_blocks"],
        sets_ms={k: r["closest_ms"] for k, r in res.items()})
    record["cluster_sc_any"] = dict(
        max_abs_err=float(max(r["any_mismatches"] for r in res.values())),
        ms=b1s["any_ms"], plain_ms=b1s["any_plain_ms"], **b1s["any_bound"],
        plain_blocks=b1s["walk_blocks"],
        sets_ms={k: r["any_ms"] for k, r in res.items()})

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
    (7) render_sum_fused against render_sum_plain at 64², spl 2, depth 3,
    on these scenes and on builtins.fused_mix_scene's six mixes: ray
    counts equal, radiance within the bars, two row tiles (by y0) equal to
    the full frame, the kernel (CUDA events, 10 calls) and the plain
    version timed beside the run's bound (fused_ops); (8) render_accumulate, fused against wavefront,
    256², spl 4, depth 4 on (i), (ii), (iv) and (v); (9) the headline launch
    of each scene (1920x1088, spl 16, depth 4; 3 on the knot): "auto" (must
    be the fused kernel alone: its LAUNCHES key counts, bf_closest does not)
    for 2 timed launches against "wavefront" (kernels 1-2, once per instance
    per query, + torch prims and shading) for 1, launches counted per path;
    (m) on a headline whose table the kernel culls by groups, the group
    size and the culled loops' tests a ray, whose needed work gives the
    bound where it is below brute force's (culled_bound), the brute-force
    one kept as bound_brute_ms;
    (7w, 7c) time_mixes on builtins.fused_variant_scene's
    scenes: all 32 instantiations on tables tested whole, and the 24
    outside instances on tables the kernel culls (group < triangles),
    image and ray count bit-equal to the wavefront's, timed (CUDA events,
    3 calls) beside one plain call.
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
    # --- phase 7: each instantiation vs its plain version, 64², spl 2, and
    # the mixes no bench scene takes (builtins.fused_mix_scene), each timed
    # (CUDA events, mean of 10) beside its bound ---
    w = h = 64
    sub = torch.tensor(5, dtype=torch.int64, device=dev)
    runs = [(name, scene, camera, kname, atol)
            for name, (scene, camera, kname, atol, _) in scenes.items()]
    for kname in B.FUSED_MIXES:
        scene, camera = B.fused_mix_scene(kname, dev)
        require(kernels.pt_fused_name(*pallas_pt.fused_variant(scene))
                == kname, f"the {kname} mix takes another instantiation")
        runs.append((kname, scene, camera, kname, PRIMS_ATOL))
    for name, scene, camera, kname, atol in runs:
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
        # the kernel computes the wavefront's operations in its order
        require(np.array_equal(out, ref),
                f"{name}: radiance not bit-equal to the wavefront's "
                f"({np.mean(np.all(out == ref, axis=-1)):.6f} of pixels)")
        halves = [to_np(pallas_pt.render_sum_fused(
            scene, cam, w, h // 2, sub, samples_per_launch=2, max_depth=3,
            y0=y0, full_width=w, full_height=h)[0]) for y0 in (0, h // 2)]
        require(np.array_equal(np.concatenate(halves), out),
                f"{name}: row tiles differ from the full frame")
        record[kname] = dict(max_abs_err=float(np.abs(out - ref).max()))
        ms = cuda_ms(lambda: pallas_pt.render_sum_fused(
            scene, cam, w, h, sub, samples_per_launch=2, max_depth=3), 10)
        plain_ms = cuda_ms(lambda: pallas_pt.render_sum_plain(
            scene, cam, w, h, sub, samples_per_launch=2, max_depth=3), 1)
        phase(f"7 {kname} vs plain", scene=name, rays=int(c_k),
              max_abs_err=np.abs(out - ref).max(),
              pixels_bit_equal=f"{np.mean(np.all(out == ref, axis=-1)):.6f}",
              row_tiles="equal", kernel_ms=f"{ms:.3f}",
              plain_ms=f"{plain_ms:.1f}",
              kernel_bound_ms="{bound_ms:.3g}({bound_by})".format(**bound(
                  (int(c_k) // 2) * (fused_ops(scene) + PAIR_OPS),
                  w * h * 16)))

    # --- phases 7w / 7c: every instantiation against the wavefront, bit
    # for bit, on a table tested whole and (outside instances) on one the
    # kernel culls ---
    for tag, culled in (("7w", False), ("7c", True)):
        for kname, row in time_mixes(dev, 3, culled=culled).items():
            phase(f"{tag} {kname} {'culled' if culled else 'whole'} vs "
                  f"plain", triangles=row["triangles"], group=row["group"],
                  rays=row["rays"], bit_equal=row["bit_equal"],
                  kernel_ms=f"{row['ms']:.3f}",
                  plain_ms=f"{row['plain_ms']:.1f}")

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
              group=pallas_pt.fused_group_size(scene),
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
        rays_launch = rays_f // 2
        record[kname]["max_abs_err"] = max(record[kname]["max_abs_err"],
                                           head_err)
        brute = bound((rays_launch // 2) * (fused_ops(scene) + PAIR_OPS),
                      W * H * 16)
        record[kname].update(ms=ms_f, plain_ms=ms_w, plain_blocks="all",
                             **brute)
        if pallas_pt.fused_group_size(scene) < scene.num_triangles:
            # --- phase m: the bound of the work a culled launch needs ---
            record[kname].update(
                **culled_bound(name, scene, cam, W, H, depth, rays_launch,
                               brute, card),
                bound_brute_ms=brute["bound_ms"])

    return launches


def time_mixes(dev, reps, culled=False):
    """Every instantiation of the kernel (builtins.fused_variant_scene's
    scene for it, its table tested whole; with culled, its culled scene at
    the scene's group size, instances left out) at phase 7's size, 64²,
    spl 2, depth 3, from subframe 5: the kernel (CUDA events,
    mean of reps calls) and its plain version, the wavefront (one call),
    whose image and ray count it must equal bit for bit → {instantiation:
    row}. Fails where they differ, or where a culled scene's table is
    tested whole."""
    import torch
    from optix_raytracer_tpu_torch import kernels as K
    from optix_raytracer_tpu_torch.scene import builtins as B
    from optix_raytracer_tpu_torch.wavefront import pallas_pt as P
    out = {}
    for name in K.FUSED_INSTANTIATIONS:
        if culled and name.startswith("pt_fused_inst"):
            continue
        scene, camera = B.fused_variant_scene(name, dev, culled)
        group = (P.fused_group_size(scene) if culled
                 else scene.num_triangles)
        require(not culled or group < scene.num_triangles,
                f"{name}: the culled scene's {scene.num_triangles} "
                f"triangles are tested whole")
        cam = camera(64, 64).params(dev)
        sub = torch.tensor(5, dtype=torch.int64, device=dev)

        def kernel():
            return P.render_sum_fused(scene, cam, 64, 64, sub,
                                      samples_per_launch=2, max_depth=3,
                                      group=group)

        def plain():
            return P.render_sum_plain(scene, cam, 64, 64, sub,
                                      samples_per_launch=2, max_depth=3)

        before = K.LAUNCHES[name]
        (rad, count), (ref, ref_count) = kernel(), plain()
        require(K.LAUNCHES[name] == before + 1,
                f"{name}: the scene took another instantiation")
        require(torch.equal(rad, ref) and int(count) == int(ref_count),
                f"{name}: the kernel differs from the wavefront")
        out[name] = dict(triangles=scene.num_triangles, group=group,
                         rays=int(count), bit_equal=True,
                         ms=cuda_ms(kernel, reps),
                         plain_ms=cuda_ms(plain, 1))
    return out


def culled_bound(name, scene, cam, W, H, depth, rays_launch, brute, card):
    """Phase m, on a headline scene whose table the fused kernel culls by
    groups: the wavefront's first sample (subframe 0) records its closest
    and shadow rays, and the culled loops' torch emulation at the scene's
    group size counts their triangle and slab tests
    (bench_fused.triangle_test_counts, which also holds their ids and
    occlusion to brute force's). The needed work of a closest ray is its
    admitted triangle tests and slab tests (PAIR_OPS, SLAB_OPS) plus its
    smooth interpolation and prim tests; a shadow ray needs one test
    (PAIR_OPS), as in brute force's bound. Scaled from the sample's rays to
    the launch's → bound(), and never above brute force's (`brute`, whose
    figure it returns where it is the smaller)."""
    from optix_raytracer_tpu_torch.tools import bench_fused
    from optix_raytracer_tpu_torch.wavefront import engine, pallas_pt
    group = pallas_pt.fused_group_size(scene)
    closest, shadow, sample_rays = bench_fused.record_queries(
        engine, scene, cam, W, H, depth)
    counts = bench_fused.triangle_test_counts(pallas_pt, scene, closest,
                                              shadow, (group,), W, H)
    c, sh = counts["closest"], counts["shadow"]
    per_hit = ((SMOOTH_OPS if scene.geom.smooth else 0)
               + sum(PRIM_OPS[k] for k in scene.prims.kinds_static))
    ops = (c["rays"] * (PAIR_OPS * c.get(f"ray_g{group}", 0)
                        + SLAB_OPS * c.get(f"slab_g{group}", 0) + per_hit)
           + sh["rays"] * PAIR_OPS)
    b = bound(ops * rays_launch / sample_rays, W * H * 16)
    require(b["bound_ms"] > 0, f"{name}: no culled work counted")
    b = min(b, brute, key=lambda x: x["bound_ms"])
    phase(f"m {name} culled work", card=repr(card), group=group,
          triangles=scene.num_triangles, sample_rays=sample_rays,
          launch_rays=rays_launch,
          **{f"{kind}_{k}": f"{v:.3f}" for kind, r in
             (("closest", c), ("shadow", sh)) for k, v in r.items()
             if k != "rays"},
          bound_ms="{bound_ms:.3f}({bound_by})".format(**b),
          bound_brute_ms=f"{brute['bound_ms']:.3f}")
    return b


def fused_ops(scene):
    """FP32 operations of one closest-hit ray of the fused kernel (3') on
    `scene`, for the bound of a launch: of the traced rays at least half
    are closest-hit rays (each NEE shadow ray follows a hit), each tested
    against every triangle and prim (on an instanced scene, the sum of the
    ranges, plus its move into each instance's object space; on a smooth
    mesh plus the normal's interpolation); a shadow ray needs one test
    (PAIR_OPS) at the least. Bytes: the radiance and count planes written
    once."""
    from optix_raytracer_tpu_torch.wavefront import pallas_pt
    ranges = pallas_pt.fused_inst_ranges(scene)
    tests = (sum(hi - lo for lo, hi in ranges) if ranges
             else scene.num_triangles)
    return (PAIR_OPS * tests + INST_XF_OPS * len(ranges)
            + (SMOOTH_OPS if scene.geom.smooth and not ranges else 0)
            + sum(PRIM_OPS[k] for k in scene.prims.kinds_static))


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
          group=pallas_pt.fused_group_size(head),
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


# Phase r: the counter RNG's shapes on the main path, a progressive strip of
# the SPD tetra (16 samples x 136 rows x 1920: 4,177,920 lanes) and an
# interactive sample (1088 x 1920: 2,088,960 lanes); calls a timing.
RNG_STRIP = (16, 136, 1920)
RNG_FRAME = (1088, 1920)
RNG_REPS = 50


def graph_ms(fn, reps):
    """Mean device time of fn() over `reps` calls captured as one CUDA graph
    (CUDA events around a replay, after a warm-up replay), so the host's
    enqueue is not timed."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def host_us(fn, reps):
    """Mean host time of an eager fn() call, to the end of its enqueue."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / reps


def rng_phases(dev, card, record):
    """Phases r1-r2, the counter RNG's kernels (csrc/rng.cu): (r1)
    rng_uniform2_kernel on random states (0, 1 and 2**32 - 1 among them)
    and rng_seed_kernel (the strip's [1, h, w] x [spl, 1, 1] broadcast; a
    flat frame) from a 0-d device subframe, each bit-equal to its plain
    version (core/rng.py's torch functions on the same tensors) at the
    strip's and the sample's shapes, both sides timed (graph_ms) beside the
    bound (the bytes a call must move, over the HBM rate: 24 a lane for a
    uniform2, 8 a lane and the operands once for a seed) and the host's µs
    a call; (r2) one main-path launch of the SPD tetra (1920x1088, 16
    samples, depth 4, impl auto: eight sample-major strips) with LAUNCHES
    reset just before it, its film and rays bit-equal to the same launch
    through the plain RNG → the two kernels' launches on it (8 seeds, 144
    draws). The record takes the strip's shape."""
    import torch
    from optix_raytracer_tpu_torch import kernels
    from optix_raytracer_tpu_torch.core import rng
    from optix_raytracer_tpu_torch.core.film import Film
    from optix_raytracer_tpu_torch.scene import builtins as B
    from optix_raytracer_tpu_torch.wavefront import engine

    def bits(t):
        return t.view(torch.int32) if t.is_floating_point() else t

    def row(name, shape, nbytes, fn, plain):
        r = dict(lanes=int(np.prod(shape)), bytes=nbytes,
                 bound_ms=1e3 * nbytes / HBM_RATE, bound_by="bytes",
                 ms=graph_ms(fn, RNG_REPS), plain_ms=graph_ms(plain, RNG_REPS),
                 host_us=host_us(fn, RNG_REPS),
                 plain_host_us=host_us(plain, RNG_REPS))
        phase(f"r1 {name} {list(shape)}", card=repr(card),
              lanes=r["lanes"], ms=f"{r['ms']:.4f}",
              plain_ms=f"{r['plain_ms']:.4f}",
              bound_ms=f"{r['bound_ms']:.4f}(bytes)",
              roofline_pct=f"{100 * r['bound_ms'] / r['ms']:.1f}",
              host_us=f"{r['host_us']:.1f}",
              plain_host_us=f"{r['plain_host_us']:.1f}", bit_equal=True)
        return r

    sub0 = torch.tensor(2 ** 32 - 5, dtype=torch.int64, device=dev)
    res = {}
    for shape in (RNG_STRIP, RNG_FRAME):
        n = int(np.prod(shape))
        g = torch.Generator(device=dev).manual_seed(n)
        state = torch.randint(0, 2 ** 32, shape, generator=g,
                              dtype=torch.int64, device=dev)
        state.view(-1)[:3] = torch.tensor([0, 1, 2 ** 32 - 1], device=dev)
        got, want = rng.uniform2(state), rng.uniform2_plain(state)
        require(all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want)),
                f"r1: rng_uniform2 differs from its plain version at {shape}")
        res["rng_uniform2", shape] = row(
            "rng_uniform2", shape, 24 * n, lambda: rng.uniform2(state),
            lambda: rng.uniform2_plain(state))
        if len(shape) == 3:
            spl, h, w = shape
            pix = torch.arange(h * w, dtype=torch.int64,
                               device=dev).reshape(1, h, w) + 952 * w
            sub = sub0 + torch.arange(spl, dtype=torch.int64,
                                      device=dev)[:, None, None]
        else:
            pix = torch.arange(n, dtype=torch.int64, device=dev)
            sub = sub0
        require(torch.equal(rng.seed(pix, sub), rng.seed_plain(pix, sub)),
                f"r1: rng_seed differs from its plain version at {shape}")
        res["rng_seed", shape] = row(
            "rng_seed", shape, 8 * (n + pix.numel() + sub.numel()),
            lambda: rng.seed(pix, sub), lambda: rng.seed_plain(pix, sub))
        del state, got, want, pix, sub
    log = kernels.build()[0].parent / "nvcc.log"
    regs = {name: v for name in ("rng_seed", "rng_uniform2")    # one entry
            for v in ptxas_report(log, (name,)).values()}      # each
    phase("r1 registers", **regs)

    # --- r2: a main-path launch of the SPD tetra, kernels against plain ---
    W, H, spl, depth = HEADLINE["width"], HEADLINE["height"], 16, 4
    scene = B.spd_tetra_scene(dev)
    cam = B.spd_tetra_camera(W, H).params(dev)

    def launch():
        film, rays = engine.render_accumulate(
            scene, cam, Film.create(H, W, dev), W, H,
            samples_per_launch=spl, max_depth=depth, impl="auto")
        torch.cuda.synchronize()
        return film.accum, int(rays)

    launch()                                # warm-up
    kernels.reset_launches()
    t0 = time.perf_counter()
    film_k, rays_k = launch()
    dt_k = time.perf_counter() - t0
    counts = {k: kernels.LAUNCHES[k] for k in ("rng_seed", "rng_uniform2")}
    saved = rng.seed, rng.uniform2
    rng.seed, rng.uniform2 = rng.seed_plain, rng.uniform2_plain
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        film_p, rays_p = launch()
        dt_p = time.perf_counter() - t0
        plain_counts = {k: kernels.LAUNCHES[k]
                        for k in ("rng_seed", "rng_uniform2")}
    finally:
        rng.seed, rng.uniform2 = saved
    require(torch.equal(film_k, film_p) and rays_k == rays_p,
            f"r2: the SPD tetra launch through the RNG kernels differs from "
            f"the plain RNG's (rays {rays_k} / {rays_p})")
    strips = -(-H // (engine._SPL_TILE_RAYS // (W * spl)))
    want = dict(rng_seed=strips, rng_uniform2=strips * (2 + 4 * depth))
    require(counts == want and not any(plain_counts.values()),
            f"r2: launches {counts} (expected {want}), plain "
            f"{plain_counts}")
    phase("r2 spd-tetra launch", card=repr(card), width=W, height=H,
          spl=spl, depth=depth, rays=rays_k, ms=f"{1e3 * dt_k:.1f}",
          plain_rng_ms=f"{1e3 * dt_p:.1f}", film_bit_equal=True,
          launches=counts)
    del scene, film_k, film_p
    for name in ("rng_seed", "rng_uniform2"):
        strip, frame = res[name, RNG_STRIP], res[name, RNG_FRAME]
        record[name] = dict(
            max_abs_err=0.0, **strip, frame_ms=frame["ms"],
            frame_plain_ms=frame["plain_ms"],
            frame_bound_ms=frame["bound_ms"], plain_blocks="all",
            main_path_launches=counts[name],
            ptxas=regs[name])
    return counts


def main():
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this smoke test runs on a GPU")
    if not os.path.isdir(os.path.join(ROOT, "optix_raytracer_tpu_torch")):
        raise SmokeFailure("optix_raytracer_tpu_torch/ not found: run from "
                           "a checkout of the repository")
    sys.path.insert(0, ROOT)
    from optix_raytracer_tpu_torch import kernels
    from optix_raytracer_tpu_torch.accel import pallas_bf, tri_groups
    from optix_raytracer_tpu_torch.core.film import Film
    from optix_raytracer_tpu_torch.scene.builtins import (cornell_box,
                                                         cornell_camera)
    from optix_raytracer_tpu_torch.wavefront import pallas_pt
    from optix_raytracer_tpu_torch.tools import bench_bf as BB
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
    record["bf_closest"] = dict(max_abs_err=0.0, bitwise_diff_hits=0)
    record["bf_any"] = dict(max_abs_err=0.0)
    geom, tri_mat, rays = random_case(dev)
    scene = cornell_box(dev)
    cam_rays, shadow = BB.camera_and_shadow_rays(scene, 256, 256, dev)
    sets = [("random mesh", geom, tri_mat, rays, None),
            ("cornell 256^2", scene.geom, scene.tri_mat, cam_rays, shadow)]
    # mixed liveness (half the lanes dead, 4099 rays: no whole block;
    # half the rays aimed at a triangle) across the group cutoff and past
    # 512 triangles, and exact ties (32 triangles twice over, each pair in
    # groups 4 apart, a quarter of the rays dead)
    for m in BF_TRIS:
        sets.append((f"m{m} mixed", *random_case(dev, m, 4099, seed=m,
                                                 dead=0.5, aim=True), None))
    sets.append(("ties", *random_case(dev, 32, 4099, seed=5, dead=0.25,
                                      dup=True, aim=True), None))
    mismatches = occluded = n_rays = 0
    for what, g, tm, r, sh in sets:
        boxes = tri_groups.bf_group_boxes(g)
        err, nbits = compare_hits(
            pallas_bf.closest_hit(g.tri_consts, tm, r, boxes=boxes),
            pallas_bf.closest_hit_plain(g.tri_consts, tm, r), what)
        record["bf_closest"]["max_abs_err"] = max(
            record["bf_closest"]["max_abs_err"], err)
        record["bf_closest"]["bitwise_diff_hits"] += nbits
        r_any = r if sh is None else sh
        occ_k = to_np(pallas_bf.any_hit(g.tri_consts, r_any, boxes=boxes))
        occ_p = to_np(pallas_bf.any_hit_plain(g.tri_consts, r_any))
        mismatches += int((occ_k != occ_p).sum())
        occluded += int(occ_k.sum())
        n_rays += r.tmin.shape[0]
    require(mismatches == 0, f"kernel 2: {mismatches} occlusion flags "
                             f"differ from the plain version")
    # kernel 1 was bit-equal to its plain version here before its redesign
    # (the parent's phase 2): any hit ray differing in a bit fails
    require(record["bf_closest"]["bitwise_diff_hits"] == 0,
            f"kernel 1: {record['bf_closest']['bitwise_diff_hits']} hit "
            f"rays differ from the plain version in t, uv or normal bits")
    phase("2 bf kernels", sets=len(sets), rays=n_rays,
          closest_max_abs_err=record["bf_closest"]["max_abs_err"],
          closest_bitwise_diff_hits=record["bf_closest"]["bitwise_diff_hits"],
          any_mismatches=mismatches, occluded=occluded)

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
          group=pallas_pt.fused_group_size(scene),
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
    # Where the kernel culls the table by groups, the bound is the needed
    # work's where that is the smaller (phase m, culled_bound), this one
    # kept as bound_brute_ms.
    m = scene.num_triangles
    rays_launch = rays_f // 2
    brute = bound(PAIR_OPS * (rays_launch // 2) * (m + 1), W * H * 16)
    record["pt_fused_cornell"].update(ms=ms_f, plain_ms=ms_w,
                                      plain_blocks="all", **brute)
    if pallas_pt.fused_group_size(scene) < m:
        record["pt_fused_cornell"].update(
            **culled_bound("cornell", scene, cam, W, H, depth, rays_launch,
                           brute, card),
            bound_brute_ms=brute["bound_ms"])

    # kernels 1 and 2 vs their plain versions on the main path's sets: the
    # 1080p camera and shadow rays and the wavefront's recorded queries on
    # the Cornell box and the smooth knot (tools/bench_bf.py), each culled
    # by the scene's group boxes; the kernels line keeps the camera /
    # shadow sets' numbers, each set's time beside its bounds (the needed
    # work where culling makes it the smaller, brute force's, the SASS
    # issue floor of the culled loop's tests)
    sass = BB.sass_counts(lib_path)
    bf_sets = {}
    for name, calls in BB.make_sets(dev, BF_SETS).items():
        kname = "bf_closest" if calls[0]["kind"] == "closest" else "bf_any"
        outs = [BB.run_call(pallas_bf, c, c["boxes"]) for c in calls]
        for c, o in zip(calls, outs):
            ref = BB.plain(c)
            if kname == "bf_closest":
                # the camera rays hold hits and misses; a recorded query
                # may hit everywhere
                err, nbits = compare_hits(o, ref, name,
                                          mixed=name == "cornell_camera")
                record[kname]["max_abs_err"] = max(
                    record[kname]["max_abs_err"], err)
                record[kname]["bitwise_diff_hits"] += nbits
            else:
                require(torch.equal(o, ref), f"{name}: occlusion differs")
        instr = sass.get(calls[0]["kind"], {})
        row = BB.bf_bounds(calls, outs, instr.get("instr_per_test"))
        row["ms"] = cuda_ms(lambda calls=calls: [
            BB.run_call(pallas_bf, c, c["boxes"]) for c in calls], 20)
        row["plain_ms"] = cuda_ms(lambda calls=calls: [
            BB.plain(c) for c in calls], 3)
        bf_sets[name] = row
        phase(f"6 bf {name}", rays=row["rays"], live=row["live"],
              tests_per_live_ray=f"{row['tests_per_live_ray']:.2f}",
              slabs_per_live_ray=f"{row['slabs_per_live_ray']:.2f}",
              needed_tests_per_live_ray=(
                  f"{row['needed_tests_per_live_ray']:.2f}"),
              brute_tests_per_live_ray=(
                  f"{row['brute_tests_per_live_ray']:.2f}"),
              ms=f"{row['ms']:.4f}", plain_ms=f"{row['plain_ms']:.3f}",
              bound_ms=f"{row['bound']['bound_ms']:.4f}"
                       f"({row['bound']['bound_by']})",
              bound_brute_ms=f"{row['bound']['bound_brute_ms']:.4f}",
              issue_floor_ms=(f"{row['issue_floor_ms']:.4f}"
                              if "issue_floor_ms" in row else None))
    require(record["bf_closest"]["bitwise_diff_hits"] == 0,
            f"kernel 1: {record['bf_closest']['bitwise_diff_hits']} hit "
            f"rays differ from the plain version in t, uv or normal bits")
    for kname, head in (("bf_closest", "cornell_camera"),
                        ("bf_any", "cornell_shadow")):
        row = bf_sets[head]
        record[kname].update(
            ms=row["ms"], plain_ms=row["plain_ms"], plain_blocks="all",
            **row["bound"], issue_floor_ms=row.get("issue_floor_ms"),
            sass=sass.get(kname[3:]),
            sets_ms={n: r["ms"] for n, r in bf_sets.items()
                     if n.endswith("shadow") == (kname == "bf_any")})
    phase("6 bf timing", card=repr(card), rays=W * H,
          bf_closest_ms=f"{record['bf_closest']['ms']:.4f}",
          bf_any_ms=f"{record['bf_any']['ms']:.4f}",
          bf_closest_plain_ms=f"{record['bf_closest']['plain_ms']:.3f}",
          bf_any_plain_ms=f"{record['bf_any']['plain_ms']:.3f}",
          closest_bitwise_diff_hits=record["bf_closest"]["bitwise_diff_hits"])

    # --- phases 7-9: the fused kernel's specular, PBR and prim variants ---
    variant_launches = variant_phases(dev, card, record)
    launches.update(variant_launches)
    torch.cuda.empty_cache()

    # --- phases k1-k3 and l: the texture variant (3' tex) and kernel 9 ---
    variant_launches.update(texture_phases(dev, card, record))
    launches.update(variant_launches)
    launches.update(texfetch_phase(dev, card, record))
    torch.cuda.empty_cache()

    # --- phases r1-r2: the counter RNG's kernels ---
    launches.update(rng_phases(dev, card, record))
    torch.cuda.empty_cache()

    # --- phases (a)-(d), (h)-(j): the large-mesh path (kernels 4-6) and
    # the queue (kernels 7-8) ---
    launches.update(knot_phases(dev, card, record))
    torch.cuda.empty_cache()

    # --- phases w1-w3: the Whitted integrator (kernels 1-2, 4-6) ---
    whitted_phases(dev, card, record)
    torch.cuda.empty_cache()

    # --- phases c1-c4: alpha cutouts and opacity micromaps (kernels 1-2,
    # 4-6) ---
    cutout_phases(dev, card, record)
    torch.cuda.empty_cache()

    # --- phases n1-n3: the denoiser (kernels 1 and 3) ---
    denoise_phases(dev, card, record)
    torch.cuda.empty_cache()

    # --- phases v1-v3: motion blur, curves and volumes (kernels 1-2) ---
    mcv_phases(dev, card, record)
    torch.cuda.empty_cache()

    # --- phases a1-a3: the host API, the BVH walk past the cluster cap
    # and the API's apps ---
    launches.update(api_phases(dev, card, record))
    torch.cuda.empty_cache()

    # --- phases s1-s4: model loading, the viewer, instanced meshes past
    # 512 triangles and the small apps (kernels 1-6); their launches are
    # added to each kernel's count ---
    for name, n in model_phases(dev, card, record).items():
        launches[name] = launches.get(name, 0) + n
    torch.cuda.empty_cache()

    # --- phases p1-p4: the multichip layer over four ranks on this card,
    # texture placement, sharded checkpoints and denoiser training (kernels
    # 1-3); their launches are added to each kernel's count ---
    p_launches = multichip_phases(dev, card, record)
    for name, n in p_launches.items():
        launches[name] = launches.get(name, 0) + n
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
                  "tools/bench_texfetch.py:97"),
        bvh_walk_closest=("optix_raytracer_tpu_torch/csrc/bvh.cu",
                          "optix_raytracer_tpu/accel/traverse.py:51"),
        bvh_walk_any=("optix_raytracer_tpu_torch/csrc/bvh.cu",
                      "optix_raytracer_tpu/accel/traverse.py:51"),
        # no pallas_call: the JAX RNG is jnp code; these replace
        # core/rng.py's torch ops on the card
        rng_seed=("optix_raytracer_tpu_torch/csrc/rng.cu",
                  "optix_raytracer_tpu_torch/core/rng.py::seed_plain"),
        rng_uniform2=("optix_raytracer_tpu_torch/csrc/rng.cu",
                      "optix_raytracer_tpu_torch/core/rng.py::uniform2_plain"))
    require(set(p_launches) <= set(meta),
            f"phases p1-p4 launched kernels outside the record: "
            f"{set(p_launches) - set(meta)}")
    # No single PyTorch call computes a Woop closest hit, a slab cull, a BVH
    # walk or a path: library_ms is null for every kernel but kernel 9
    # (torch's row gather).
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
