"""The knot scenes' probe sets and the work counts of the cluster kernels
(4-8), shared by chip_smoke.py and tools/bench_sc_walks.py: the knot
configurations and frames, the probe ray sets and the rays one sample-major
strip of the main path hands the cluster table, CUDA-event timing, timed
launches and their A/B against a parent checkout of the port
(`load_parent`, `launch_ab`), the least work (pair and slab tests, bytes) each kernel's
outputs need, as a bound on the card (`bound`), and ptxas's report of a
build (`ptxas_report`).

The peaks are the H100 SXM data sheet's (dense, at 700 W): FP32 outside the
tensor cores, and HBM3.
"""
from __future__ import annotations

import importlib
import importlib.util
import os
import re
import sys
import time

import numpy as np
import torch

from .. import kernels
from ..accel import clusters as C
from ..accel import qwalk as Q
from ..core import rng as _rng
from ..core.camera import generate_rays
from ..core.film import Film
from ..core.rays import Rays
from ..core.vecmath import dot
from ..scene.builtins import knot_camera
from ..shade.sampling import cosine_sample_hemisphere
from ..wavefront import engine

# bench.py:299-304 (mesh, frame, depth) on the lit builtin knot_scene
KNOT = dict(segments=200, sides=63, width=1920, height=1088, spl=16,
            depth=3)
KNOT_STREAM = dict(segments=1000, sides=250)                # bench.py:124
# bench.py:361's 4.0M-triangle mesh on the lit knot_scene, at the knot
# headline's frame, spl and depth: the supercluster tier (kernels 5c/6c)
KNOT_SC = dict(segments=1450, sides=1380, width=1920, height=1088, spl=16,
               depth=3)

FP32_PEAK = 67e12
HBM_RATE = 3.35e12
PAIR_OPS = 30      # FP32 operations of one Woop ray-triangle test
SLAB_OPS = 20      # FP32 operations of one ray-box slab test
RAY_BYTES = 32     # ox oy oz dx dy dz tmin tmax
BOX_BYTES = 24     # lo xyz, hi xyz
SLOT_BYTES = 4 * 128               # one constant row of a 128-slot cluster
CLOSEST_ROWS, ANY_ROWS = 23, 12    # rows a closest / any-hit walk reads


def bound(ops, nbytes):
    """The least time the card could take for work of `ops` FP32 operations
    moving `nbytes` bytes: the larger of ops / FP32 peak and bytes / HBM
    rate → dict(bound_ms, bound_by)."""
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_RATE
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def listed_words(counts, lists):
    """The valid entries of per-block lists → (blocks [E] int64, list words
    [E] int32: box id in bits 0-15, gate bits 16-23)."""
    nb = counts.numel()
    lst = lists.reshape(nb, -1)
    valid = (torch.arange(lst.shape[1], device=lst.device)[None]
             < counts.reshape(nb, 1))
    be, ke = torch.nonzero(valid, as_tuple=True)
    return be, lst[be, ke]


def listed_entries(counts, lists):
    """The valid entries of per-block lists → (blocks [E], box ids [E]),
    each int64; the group bits of an entry are dropped."""
    be, we = listed_words(counts, lists)
    return be, (we & 0xFFFF).long()


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


def sc_pair_counts(counts, lists, member, packed, out, closest,
                   chunk=4096):
    """The pair tests (ray x triangle slot) of kernels 5c / 6c on these
    lists at three granularities and under the admission rule, over all
    blocks → dict: block (each listed supercluster's block-union members,
    every ray of the block: the parent design's kernel and the plain
    walks), warp (the members some ray of the 32-ray warp crosses, the
    warp's rays), ray (the members each ray's own slab test crosses) and
    admitted (the rule, `sc_admitted_pairs_plain`, at the walk's final
    state: for 5c at the ray's row t, a lower bound on the kernel's, whose
    running t is never below it; for 6c on every live ray, occlusion not
    applied, an upper bound). The needed count is walk_bound's."""
    nb, m = counts.numel(), member.shape[2]
    rays = packed.reshape(nb, C.SUB, 8)
    best = out[:, 0].reshape(nb, C.SUB) if closest else None
    be, se = listed_entries(counts, lists)
    tot = dict(block=0, warp=0, ray=0, admitted=0)
    for i in range(0, be.numel(), chunk):
        b, s = be[i:i + chunk], se[i:i + chunk]
        a, boxes = rays[b], member[s]
        cross = C._member_cross(a, boxes)                    # [E, 256, M]
        adm = C.sc_admitted_pairs_plain(
            a, boxes, None if best is None else best[b])
        tot["block"] += int(cross.any(dim=1).sum()) * C.SUB
        tot["warp"] += int(cross.reshape(-1, 8, 32, m).any(dim=2).sum()) * 32
        tot["ray"] += int(cross.sum())
        tot["admitted"] += int(adm.sum())
    return {k: v * C.LANES for k, v in tot.items()}


def walk_pair_counts(counts, lists, aabb, packed, out, closest, gate,
                     chunk=4096):
    """The pair tests (ray x triangle slot) of kernels 5 / 6 on these lists
    at three granularities and under the admission rule, over all blocks →
    dict: block (every ray of the block against every listed cluster: the
    ungated walk of the parent design and of the plain version), warp (the
    32-ray groups of which some ray crosses the cluster, every ray of such
    a group: the gated walk's, as the exact cull's gate bits give them),
    ray (the clusters each ray's own slab test crosses) and admitted (the
    rule, `admitted_pairs_plain`, gated when `gate`, at the walk's final
    state: for 5 at the ray's row t, a lower bound on the kernel's, whose
    best t is never below it; for 6 on every live ray, occlusion not
    applied, an upper bound). The needed count is walk_bound's."""
    nb = counts.numel()
    rays = packed.reshape(nb, C.SUB, 8)
    best = out[:, 0].reshape(nb, C.SUB) if closest else None
    boxes = C._entry_boxes(aabb)
    be, we = listed_words(counts, lists)
    tot = dict(block=0, warp=0, ray=0, admitted=0)
    for i in range(0, be.numel(), chunk):
        b, w = be[i:i + chunk], we[i:i + chunk]
        c, gm = (w & 0xFFFF).long(), (w >> 16) & 0xFF
        a = rays[b]
        cross = C._member_cross(a, boxes[c])[:, :, 0]            # [E, 256]
        adm = C.admitted_pairs_plain(a, boxes[c], gm, gate,
                                     None if best is None else best[b])
        tot["block"] += int(b.numel()) * C.SUB
        tot["warp"] += int(cross.reshape(-1, 8, 32).any(dim=2).sum()) * 32
        tot["ray"] += int(cross.sum())
        tot["admitted"] += int(adm.sum())
    return {k: v * C.LANES for k, v in tot.items()}


def walk_bound(counts, lists, boxes, n_real, packed, out, closest, sc=0):
    """Bound of a walk on all blocks of these lists, from needed_work with
    the walk's own result: out is the closest walk's rows (the hit t ends
    each ray's window) or the any-hit walk's occlusion. The pair tests (and,
    for the supercluster walks, sc > 0, the member slab tests) over the FP32
    peak; the rays, counts, listed entries (id + bound), the listed
    superclusters' member boxes, the crossed members' rows and the output
    over the HBM rate."""
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


def queue_counts(steps, qrays, aabb, n_items, closest, step_chunk=256):
    """Kernel 8's lane tests (ray x triangle slot) on a query's live steps
    (steps [3, S], planar qrays, the table's aabb; n_items = 32 S work
    items), three ways a step → dict: tested (every lane: 256 x 128, the
    parent design's), admitted (`qwalk.queue_admitted_plain`, the kernel's
    rule) and needed (the rays whose own slab test crosses the unwidened
    cluster box); and the queue's own floor (`queue_floor`, `bound`): the
    marshalled rays in and candidates out, n_items x 8 x (32 B + 32 B or
    4 B), over the HBM rate, against the admitted pair tests over the FP32
    peak."""
    n_adm = int(Q.queue_admitted_plain(steps, qrays, aabb,
                                       step_chunk).sum())
    boxes = C._entry_boxes(aabb)
    needed = 0
    for c, _, rays in Q._step_chunks(steps, qrays, step_chunk):
        needed += int(C._slab_cross(rays, boxes[c][:, 0:3],
                                    boxes[c][:, 3:6])[0].sum())
    per = max(steps.shape[1], 1)
    nbytes = n_items * Q.OCT * (RAY_BYTES + (RAY_BYTES if closest else 4))
    return dict(lane_tests_per_step=dict(
        tested=Q.ROWS * C.LANES, admitted=n_adm * C.LANES / per,
        needed=needed * C.LANES / per),
        queue_floor=bound(PAIR_OPS * n_adm * C.LANES, nbytes))


def ptxas_report(log, names):
    """ptxas's registers, spills and shared memory of each kernel entry
    whose mangled name holds one of `names`, from a build's nvcc.log →
    {"kernel<template args>": "N registers, S bytes spill stores, L bytes
    spill loads, M bytes smem"}."""
    out, entry = {}, None
    for ln in log.read_text().splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            m = re.search(r"\d([a-z_]+kernel)((?:I(?:L[ib]\d+E)+E)?)", name)
            entry = None
            if m and any(n in name for n in names):
                args = re.findall(r"L[ib](\d+)E", m.group(2))
                entry = m.group(1) + (f"<{','.join(args)}>" if args else "")
                out[entry] = []
        elif entry and "spill stores" in ln:
            out[entry] += [p.strip() for p in ln.split(",")[1:]]
        elif entry and "Used" in ln:
            used = ln.split(" : ")[-1].split(",")
            out[entry] = [used[0].replace("Used ", "").strip()] + out[
                entry] + [p.strip() for p in used if "smem" in p]
    return {k: ", ".join(v) for k, v in out.items()}


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps launches, after one warm-up."""
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


def timed_launches(scene, cam, W, H, spl, depth, impl, launches, dev):
    """One warm-up launch from subframe 0, then `launches` timed launches
    continuing its film → (film, rays of the timed launches, seconds, peak
    bytes, first film, rays of the first launch, kernel launch counts of
    this path alone: set to 0 just before its first launch, read just after
    its last; the warm-up's seconds)."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    first, first_rays = engine.render_accumulate(
        scene, cam, Film.create(H, W, dev), W, H, spl, depth, impl=impl)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    film = first
    torch.cuda.reset_peak_memory_stats(dev)
    rays = []
    t0 = time.perf_counter()
    for _ in range(launches):
        film, r = engine.render_accumulate(scene, cam, film, W, H, spl, depth,
                                    impl=impl)
        rays.append(r)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    return (film, int(sum(int(r) for r in rays)), dt,
            torch.cuda.max_memory_allocated(dev), first, int(first_rays),
            counts, first_s)


def load_parent(root):
    """DIR/optix_raytracer_tpu_torch, a checkout of the port (an earlier
    tree), as the package `ort_parent` (its kernels built from its own
    sources at first use) → the package."""
    if "ort_parent" in sys.modules:
        return sys.modules["ort_parent"]
    pkg = os.path.join(root, "optix_raytracer_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "ort_parent", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["ort_parent"] = mod
    spec.loader.exec_module(mod)
    return mod


# chip_smoke.py's launches (its phases 6, d, j, g): scene, impl, ORT_QWALK.
AB_LAUNCHES = dict(cornell_auto=("cornell", "auto", "0"),
                   cornell_wavefront=("cornell", "wavefront", "0"),
                   knot25k_auto=("knot25k", "auto", "0"),
                   knot25k_sequential=("knot25k", "wavefront", "0"),
                   knot25k_queue=("knot25k", "auto", "1"),
                   knot4m_auto=("knot4m", "auto", "0"))


def _launch_scene(pkg, what, dev):
    """Package pkg's scene `what` → (scene, camera params, W, H, spl,
    depth), at chip_smoke.py's frames."""
    TB = importlib.import_module(pkg + ".scene.builtins")
    if what == "cornell":
        W, H, spl, depth = TB.HEADLINE_FRAME
        return (TB.cornell_box(dev), TB.cornell_camera(W, H).params(dev), W,
                H, spl, depth)
    K = KNOT if what == "knot25k" else KNOT_SC
    W, H = K["width"], K["height"]
    return (TB.knot_scene(K["segments"], K["sides"], device=dev),
            TB.knot_camera(W, H).params(dev), W, H, K["spl"], K["depth"])


def launch_ab(dev, parent_root, names, launches=1):
    """Whole launches (AB_LAUNCHES `names`) of this tree's engine and, with
    a parent_root, the parent's (load_parent: its own engine, kernels and
    builders): one warm-up each, then `launches` timed (host clock,
    synchronized; timed_launches) in the order parent, this, this, parent
    (this, this without a parent) → {name: row of ms a launch per tree and
    the first launch's rays}; the trees' first-launch rays must be
    equal."""
    trees = {"this": "optix_raytracer_tpu_torch"}
    order = ("this", "this")
    if parent_root is not None:
        load_parent(parent_root)
        trees["parent"] = "ort_parent"
        order = ("parent", "this", "this", "parent")
    out, made = {}, {}
    for name in names:
        what, impl, qwalk = AB_LAUNCHES[name]
        if made.get("what") != what:
            made = {"what": what}
            torch.cuda.empty_cache()
            for tree, pkg in trees.items():
                made[tree] = _launch_scene(pkg, what, dev)
        keep = os.environ.get("ORT_QWALK")
        os.environ["ORT_QWALK"] = qwalk
        row, first = dict(impl=impl, qwalk=qwalk), {}
        try:
            for tree in order:
                scene, cam, W, H, spl, depth = made[tree]
                TK = importlib.import_module(trees[tree]
                                             + ".tools.knot_probe")
                r = TK.timed_launches(scene, cam, W, H, spl, depth, impl,
                                      launches, dev)
                row.setdefault(f"{tree}_ms_per_launch", []).append(
                    1e3 * r[2] / launches)
                first.setdefault(tree, r[5])
        finally:
            if keep is None:
                os.environ.pop("ORT_QWALK", None)
            else:
                os.environ["ORT_QWALK"] = keep
        if len(set(first.values())) != 1:
            raise SystemExit(f"{name}: first-launch rays differ: {first}")
        row.update(dim=f"{W}x{H}", spl=spl, depth=depth,
                   first_launch_rays=first["this"])
        out[name] = row
    return out


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

    def permute(r, perm):
        return Rays(origin=r.origin[perm], direction=r.direction[perm],
                    tmin=r.tmin[perm], tmax=r.tmax[perm])

    n = width * height
    cam = knot_camera(width, height).params(device)
    rays, _ = generate_rays(cam, width, height, rng_state=None, jitter=False)
    prim = permute(rays.reshape(n),
                   torch.as_tensor(tile_order(width, height), device=device))
    hits = C.closest_hit(scene.clusters, prim)
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
    order = torch.argsort(C.coherence_key(scene.clusters, bounce),
                          stable=True)
    return prim, shadow, permute(bounce, order)


def main_path_strip_sets(scene, cam, width, height, spl, depth):
    """The rays the knot's main path hands kernels 4-6 in one sample-major
    strip: render_sample_group at render_sum_sample_major's strip height
    (136 rows x 1920 x 16 samples = 4,177,920 lanes), the middle strip of
    the frame, subframe 0. Each cluster query of the strip is recorded as
    (rays, exact, group_walk) → (closest-hit calls, any-hit calls), one
    per bounce."""
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
    if not all(len(c) == depth for c in calls.values()):
        raise RuntimeError("the strip did not query the cluster table once "
                           "per bounce")
    return calls["closest_hit"], calls["any_hit"]


def cull_counts(aabb, packed, group: int, chunk: int = 1 << 14):
    """What kernels 4 and 7 test on these rays at `group` columns a group
    box, over the live rays → dict: live rays, live blocks (blocks with a
    live ray), crossed (live (ray, column) pairs whose slab test crosses,
    padding columns left out), group_tests (group boxes of kind 1 a live
    ray tests), groups_crossed (of kind 1, or admitted whole: kind 2),
    member_tests (the admitted non-padding members); each live ray also
    tests the padding box once (`clusters.cull_admitted_pairs_plain`)."""
    glo, ghi, kind = C.cull_group_boxes(aabb, group)
    boxes, pad, _ = C._cull_columns(aabb)
    lo, hi = boxes[:, 0:3].T[None], boxes[:, 3:6].T[None]
    live = packed[:, 7] > packed[:, 6]
    rays = packed[live]
    n_members = (~pad).reshape(-1, group).sum(dim=1)          # [G]
    tot = dict(crossed=0, groups_crossed=0, member_tests=0)
    for s in range(0, rays.shape[0], chunk):
        a = rays[s:s + chunk][None]
        gcross = C._slab_cross(a, glo.T[None], ghi.T[None])[0][0]
        gadm = (gcross & (kind == 1)[None]) | (kind == 2)[None]
        cross = C._slab_cross(a, lo, hi)[0][0] & ~pad[None]
        tot["crossed"] += int(cross.sum())
        tot["groups_crossed"] += int(gadm.sum())
        tot["member_tests"] += int((gadm.to(torch.int64)
                                    * n_members[None]).sum())
    n_live = int(live.sum())
    return dict(live=n_live,
                live_blocks=int(live.reshape(-1, C.SUB).any(dim=1).sum()),
                group_tests=n_live * int((kind == 1).sum()), **tot)


def cull_fields(aabb, packed, out_bytes, prefix, group=None):
    """Kernel 4 or 7 on these rays (a cull table aabb, `out_bytes` per
    output entry: 8 for kernel 4's tn and gm, 4 for kernel 7's om) at
    `group` columns a group box (the kernels' own, clusters.cull_group, by
    default) → the fields chip_smoke.py and bench_sc_walks.py print for a
    set, each named `{prefix}_...`: the bound (bound_ms / bound_by of the
    work the outputs need, bound_brute_ms of every live ray against every
    real column, the parent design's), the group size, live rays a live
    block, and per live ray the crossed columns, the group boxes crossed
    and the slab tests the kernel makes (group boxes, admitted members,
    the padding box). The needed operations are one slab test for each
    (live ray, column) pair that crosses, padding columns left out, and
    one test of the padding box a live ray where the table has padding;
    the bytes are the rays in, the boxes and the [n_blocks, c_pad]
    outputs. The needed bound is never above brute force's."""
    _, pad, _ = C._cull_columns(aabb)
    c_pad = pad.numel()
    group = C.cull_group(c_pad) if group is None else group
    cc = cull_counts(aabb, packed, group)
    nbytes = (packed.shape[0] * RAY_BYTES + c_pad * BOX_BYTES
              + (packed.shape[0] // C.SUB) * c_pad * out_bytes)
    pad_tests = cc["live"] if bool(pad.any()) else 0
    needed = bound(SLAB_OPS * (cc["crossed"] + pad_tests), nbytes)
    brute = bound(SLAB_OPS * cc["live"] * int((~pad).sum()), nbytes)
    if needed["bound_ms"] > brute["bound_ms"]:
        needed = brute
    live = max(cc["live"], 1)
    return {f"{prefix}_bound": dict(needed, bound_brute_ms=brute["bound_ms"]),
            f"{prefix}_group": group,
            f"{prefix}_live_per_live_block": (cc["live"]
                                              / max(cc["live_blocks"], 1)),
            f"{prefix}_crossed_per_ray": cc["crossed"] / live,
            f"{prefix}_groups_crossed_per_ray": cc["groups_crossed"] / live,
            f"{prefix}_tests_per_ray": (cc["group_tests"] + cc["member_tests"]
                                        + cc["live"]) / live}
