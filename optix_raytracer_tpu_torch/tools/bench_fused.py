"""A/B and counts of the fused path-trace kernel (kernel 3 and its variants
3', `csrc/pt_fused.cuh`).

Scenes (--scene, comma-separated; all by default):

- the seven headline scenes at their bench.py frame, samples per launch
  and depth (`builtins.HEADLINE_FRAME`, `SMOOTH_KNOT_FRAME`,
  `TEXTURED_FRAME`): `cornell`, `prims` (prims + glass), `pbr`, `mirror`,
  `instanced`, `smooth_knot` (the 482-triangle knot; depth 3) at 1920x1088,
  16 samples, depth 4, and `textured` (4 samples, depth 3);
- the cutoff meshes, at the knot headline's frame, samples and depth:
  `knot<M>` (knot_scene of M = 2 segments sides + 2 triangles, smooth) and
  `knot<M>_flat` (the same mesh without its vertex normals) for M in 10-482
  (CUTOFF_KNOTS), and `tex<M>` (the textured scene's quads cut into
  grid x grid cells, M = 4 grid² triangles, CUTOFF_TEX_GRIDS) at the
  textured headline's.

Per scene it renders from subframe 0 with `render_sum_fused` and times the
launch (CUDA events, mean of --reps launches after a warm-up; --reps 0 times
nothing): at the scene's own group size (`pallas_pt.fused_group_size`) and,
for the cutoff table, with the table tested whole and in groups of each size
of --group below the triangle count (`render_sum_fused(group=)`); every one
of these images and ray counts must be bit-equal. With --parent DIR it also
loads DIR's checkout of the port as its own package `ort_parent` (its
kernels built from its own sources), renders the scene with that tree's
builders and kernel, requires its image and ray count to be bit-equal, and
times the two trees in the order parent, this tree, this tree, parent. A
scene the parent's builders cannot make (a flat knot, a cut textured scene)
runs without it.

With --counts it first prints, per scene, the counts behind the kernel's
design:

- the warp steps: from the wavefront's per-(pixel, sample) path segments
  (`path_lengths`, whose rays must sum to the kernel's count), in
  warps of 32 consecutive pixels and of the kernel's 8x4 tiles
  (`warp_order`): the lock-step cost (per sample the longest path of the
  warp's lanes, summed) against the regenerating one (the largest per-lane
  total of segments), and each one's lane efficiency;
- the triangle tests a live ray, on the closest and shadow rays of the
  wavefront's first sample (recorded at `engine.scene_closest` /
  `scene_any`): brute force (every triangle; a shadow ray up to its first
  occluder), per group size of --group the culled loops' own tests and slab
  tests (`pallas_pt.fused_group_closest_plain` / `_any_plain`, which must
  give brute force's ids and occlusion) and the 32-lane warp union, and
  the needed (the pairs `tri_accept` takes on the closest ray's window; a
  shadow ray's occluded share);
- the build figures of all 32 instantiations from ptxas's lines in
  `_build/<hash>/nvcc.log` (registers and spill bytes a thread) and the
  blocks an SM they give at each scene's shared memory (`blocks_per_sm`,
  from the registers, the kernel's 128 threads and the shared bytes); with
  --parent also the parent's, and the other kernels' lines must be equal
  in both trees.

    python -m optix_raytracer_tpu_torch.tools.bench_fused [--parent DIR]
        [--counts] [--group 8,16] [--scene cornell,knot130,...] [--reps 10]
        [--out FILE]

Needs a CUDA device. Prints one JSON line per scene (and per build), then
the card's name and power limit; --out also writes them as one JSON file.
`run` is the same for scripts; `record_queries` / `triangle_test_counts`
also serve chip_smoke.py's phase m.
"""
from __future__ import annotations

import argparse
import importlib
import inspect
import json
import os
import re
import subprocess

SCENES = ("cornell", "prims", "pbr", "mirror", "instanced", "smooth_knot",
          "textured")
# knot_scene (segments, sides) of the cutoff meshes: 10 to 394 triangles;
# the smooth knot headline's (16, 15) gives 482.
CUTOFF_KNOTS = ((2, 2), (2, 4), (3, 4), (4, 4), (4, 8), (8, 8), (8, 12),
                (10, 13), (12, 14), (14, 14), (16, 15))
# textured_scene grids of the cutoff table: 16, 64 and 256 triangles.
CUTOFF_TEX_GRIDS = (2, 4, 8)
CUTOFF = tuple(f"knot{2 * a * b + 2}" for a, b in CUTOFF_KNOTS[:-1]) + tuple(
    f"knot{2 * a * b + 2}_flat" for a, b in CUTOFF_KNOTS) + tuple(
    f"tex{4 * g * g}" for g in CUTOFF_TEX_GRIDS)
WARP = 32
# Rays a chunk of the counts' torch emulation.
COUNT_CHUNK = 1 << 18
# The H100's limits on the blocks an SM (compute capability 9.0): registers
# (given to a warp in units of 256), warps, blocks, shared bytes (each block
# also holds 1 KB of the system's); the fused kernel's threads a block
# (csrc/pt_fused.cuh kThreads).
SM_REGS, REG_UNIT, SM_WARPS, SM_BLOCKS = 65536, 256, 64, 32
SM_SMEM, BLOCK_SMEM_SYS = 233472, 1024
FUSED_THREADS = 128


def make_scenes(pkg, dev, names):
    """Package `pkg`'s scenes `names` → {name: (scene, camera params, width,
    height, spl, depth)} at this package's headline frames; a scene the
    package's builders cannot make is left out."""
    from optix_raytracer_tpu_torch.scene import builtins as F
    B = importlib.import_module(pkg + ".scene.builtins")
    frame, knot_frame = F.HEADLINE_FRAME, F.SMOOTH_KNOT_FRAME
    tx = F.TEXTURED_FRAME
    make = dict(
        cornell=lambda: (B.cornell_box(dev), B.cornell_camera, frame),
        prims=lambda: (B.prims_scene(dev), B.prims_camera, frame),
        pbr=lambda: (B.pbr_cornell(dev), B.cornell_camera, frame),
        mirror=lambda: (B.pbr_cornell(dev, 1.0, 0.02), B.cornell_camera,
                        frame),
        instanced=lambda: (B.cornell_box_instanced(dev), B.cornell_camera,
                           frame),
        smooth_knot=lambda: (B.knot_scene(*F.SMOOTH_KNOT_MESH, device=dev),
                             B.knot_camera, knot_frame),
        textured=lambda: (B.textured_scene(dev), B.textured_camera, tx))
    knot_kw = inspect.signature(B.knot_scene).parameters
    tex_kw = inspect.signature(B.textured_scene).parameters
    for a, b in CUTOFF_KNOTS:
        m = 2 * a * b + 2
        make[f"knot{m}"] = (lambda a=a, b=b: (
            B.knot_scene(a, b, device=dev), B.knot_camera, knot_frame))
        if "smooth" in knot_kw:
            make[f"knot{m}_flat"] = (lambda a=a, b=b: (
                B.knot_scene(a, b, device=dev, smooth=False), B.knot_camera,
                knot_frame))
    if "grid" in tex_kw:
        for g in CUTOFF_TEX_GRIDS:
            make[f"tex{4 * g * g}"] = (lambda g=g: (
                B.textured_scene(dev, grid=g), B.textured_camera, tx))
    out = {}
    for name in names:
        if name not in make:
            if pkg == "optix_raytracer_tpu_torch":
                raise SystemExit(f"bench_fused: no scene {name!r}")
            continue
        scene, camera, (w, h, spl, depth) = make[name]()
        out[name] = (scene, camera(w, h).params(dev), w, h, spl, depth)
    return out


def warp_order(width, height, tiled):
    """The pixels of each warp of the kernel, warp after warp → int64
    [warps * 32], -1 for a lane past the frame: with `tiled` the kernel's
    order (a block a 16x8 tile, a warp an 8x4 tile of it, csrc/pt_fused.cuh
    kBlockW...), else 32 consecutive pixels of the row-major frame."""
    import torch
    n = width * height
    if not tiled:
        return torch.cat([torch.arange(n),
                          torch.full(((-n) % WARP,), -1)])
    tiles_x, tiles_y = -(-width // 16), -(-height // 8)
    b = torch.arange(tiles_x * tiles_y)[:, None]
    t = torch.arange(128)[None]
    warp, lane = t // WARP, t % WARP
    gx = (b % tiles_x) * 16 + (warp % 2) * 8 + lane % 8
    gy = (b // tiles_x) * 8 + (warp // 2) * 4 + lane // 8
    return torch.where((gx < width) & (gy < height), gy * width + gx,
                       -1).reshape(-1)


def _in_warps(x, order, fill=0):
    """x [..., P] in pixel order → [..., warps, 32] in warp order (`order`
    from warp_order; lanes past the frame hold `fill`)."""
    import torch
    pad = torch.full(x.shape[:-1] + (1,), fill, dtype=x.dtype,
                     device=x.device)
    idx = torch.where(order < 0, x.shape[-1], order).to(x.device)
    return torch.cat([x, pad], dim=-1)[..., idx].reshape(
        x.shape[:-1] + (-1, WARP))


def warp_steps(segments, order=None, warp=WARP):
    """Per-(sample, pixel) path segments [spl, P] → the bounce steps the
    warps issue (pixels in warps by `order`, warp_order's; None: `warp`
    consecutive pixels): lock-step (per sample the warp's longest path,
    summed over samples and warps), regenerating (the warp's largest
    per-lane total), the lanes' own steps, and each schedule's lane
    efficiency (lane steps / (warp x warp steps))."""
    import torch
    spl, p = segments.shape
    seg = segments.to(torch.int64)
    if order is None:
        seg = torch.nn.functional.pad(seg, (0, (-p) % warp)).reshape(
            spl, -1, warp)
    else:
        seg = _in_warps(seg, order)
    lock = int(seg.amax(dim=2).sum())
    regen = int(seg.sum(dim=0).amax(dim=1).sum())
    lane = int(seg.sum())
    return dict(lockstep=lock, regen=regen, lane_steps=lane,
                lockstep_lane_eff=lane / max(warp * lock, 1),
                regen_lane_eff=lane / max(warp * regen, 1))


def path_lengths(scene, cam_params, width, height, subframe,
                 samples_per_launch, max_depth):
    """Per (sample, pixel) of a launch, the path's segments (closest-hit
    queries, the fused kernel's loop iterations), read from the `active`
    lanes each wavefront bounce is given (engine._bounce wrapped for the
    call) → (segments int32 [spl, H * W] in pixel order, rays traced int64
    [spl], which sum to the launch's count). The scene takes the
    wavefront's lane-order path (no cluster table), as every scene of the
    fused kernel does."""
    import torch
    from optix_raytracer_tpu_torch.wavefront import engine as E
    if scene.has_clusters:
        raise SystemExit("path_lengths: a cluster scene sorts its lanes")
    bounce = E._bounce
    segs, rays = [], []
    for i in range(samples_per_launch):
        seg = torch.zeros((width * height,), dtype=torch.int32,
                          device=scene.device)

        def counted(scene_, state, *args, **kw):
            seg.add_(state["active"].to(torch.int32))
            return bounce(scene_, state, *args, **kw)

        try:
            E._bounce = counted
            _, count = E.render_sample(scene, cam_params, width, height,
                                       subframe + i, max_depth=max_depth)
        finally:
            E._bounce = bounce
        segs.append(seg)
        rays.append(count.to(torch.int64))
    return torch.stack(segs), torch.stack(rays)


def record_queries(E, scene, cam, w, h, depth):
    """The closest and shadow rays of the wavefront's first sample
    (subframe 0), recorded at engine.scene_closest / scene_any → (closest
    rays, shadow rays, the sample's rays traced: the kernel's count, whose
    shadow rays include those of lanes facing away from the light, which
    test nothing), one Rays per bounce each, in lane (pixel) order."""
    calls = dict(scene_closest=[], scene_any=[])
    query = {name: getattr(E, name) for name in calls}

    def recorder(name):
        def call(sc, rays, *args, **kw):
            calls[name].append(rays)
            return query[name](sc, rays, *args, **kw)
        return call

    try:
        for name in calls:
            setattr(E, name, recorder(name))
        rays = int(E.render_sample(scene, cam, w, h, 0, max_depth=depth)[1])
    finally:
        for name, fn in query.items():
            setattr(E, name, fn)
    return calls["scene_closest"], calls["scene_any"], rays


def _warp_union_tests(admitted, live, group, m, order):
    """Tests a lane pays when its warp tests every group some live lane of
    the warp admits: admitted [N, G] bool in pixel order, warps by `order`
    (warp_order's) → the sum over live lanes of their warp's union tests."""
    import torch
    g = admitted.shape[1]
    adm = _in_warps((admitted & live[:, None]).T, order, False)  # [G, w, 32]
    lv = _in_warps(live, order, False)                           # [w, 32]
    sizes = torch.full((g, 1), group, dtype=torch.int64, device=adm.device)
    sizes[-1] = m - group * (g - 1)
    union = (adm.any(dim=2).to(torch.int64) * sizes).sum(dim=0)  # [w]
    return int((union * lv.sum(dim=1)).sum())


def triangle_test_counts(P, scene, closest, shadow, groups, width, height):
    """Triangle tests a live ray of the recorded queries ([width x height]
    each, pixel order): brute force, per group size below the triangle
    count the culled loops' own (`ray`) and slab (`slab`) tests and the
    warp-union tests in row-order warps (`rows`) and in the kernel's 8x4
    tiles (`tiles`), and the needed: accepted pairs a closest
    ray (all of its window), the occluded share of the shadow rays.
    Instances: brute force only. Raises SystemExit where a culled loop's ids
    or occlusion differ from brute force's."""
    import torch
    from optix_raytracer_tpu_torch.accel.pallas_bf import _accept, _tri_test
    from optix_raytracer_tpu_torch.accel.tri_groups import fused_group_boxes
    tri = scene.geom.tri_consts
    m = scene.num_triangles
    ranges = P.fused_inst_ranges(scene)
    groups = tuple(g for g in groups if g < m)
    kinds = ("ray", "slab", "rows", "tiles")
    out = {}
    for kind, sets in (("closest", closest), ("shadow", shadow)):
        tot = dict(rays=0, brute=0, needed=0,
                   **{f"{k}_g{g}": 0 for g in groups for k in kinds})
        walk = (P.fused_group_closest_plain if kind == "closest"
                else P.fused_group_any_plain)
        for rays in sets:
            r = rays.reshape(rays.tmin.numel())
            live = r.tmax > r.tmin
            tot["rays"] += int(live.sum())
            if ranges:
                tot["brute"] += int(live.sum()) * sum(hi - lo
                                                      for lo, hi in ranges)
                continue
            adm = {g: [] for g in groups}
            for s in range(0, live.shape[0], COUNT_CHUNK):
                e = min(s + COUNT_CHUNK, live.shape[0])
                o, d = r.origin[s:e], r.direction[s:e]
                tmin, tmax = r.tmin[s:e], torch.where(live[s:e], r.tmax[s:e],
                                                      r.tmin[s:e])
                lv = live[s:e]
                res = walk(tri, None, m, o, d, tmin, tmax)
                tot["brute"] += int(res[-1].sum())
                if kind == "closest":
                    cols = ([o[:, k:k + 1] for k in range(3)]
                            + [d[:, k:k + 1] for k in range(3)])
                    tt, uu, vv, dpz = _tri_test(tri, *cols)
                    tot["needed"] += int((_accept(
                        tt, uu, vv, dpz, tmin[:, None], tmax[:, None])
                        & lv[:, None]).sum())
                else:
                    tot["needed"] += int((res[0] & lv).sum())
                for g in groups:
                    boxes = fused_group_boxes(scene.geom, g)
                    res_g = walk(tri, boxes, g, o, d, tmin, tmax,
                                 with_groups=True)
                    same = (res_g[1], res[1]) if kind == "closest" else (
                        res_g[0], res[0])
                    if not torch.equal(*same):
                        raise SystemExit(f"group {g}: the culled {kind} loop "
                                         f"differs from brute force")
                    tot[f"ray_g{g}"] += int(res_g[-3].sum())
                    tot[f"slab_g{g}"] += int(res_g[-2].sum())
                    adm[g].append(res_g[-1])
            for g, parts in adm.items():
                if not parts:
                    continue
                for key, tiled in (("rows", False), ("tiles", True)):
                    tot[f"{key}_g{g}"] += _warp_union_tests(
                        torch.cat(parts), live, g, m,
                        warp_order(width, height, tiled))
        n = max(tot["rays"], 1)
        out[kind] = dict(rays=tot["rays"], **{
            k: v / n for k, v in tot.items() if k != "rays" and v})
    return out


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_FUSED = re.compile(r"pt_fused_kernelILi(\d)ELb([01])ELb([01])ELb([01])E")


def ptxas_lines(log_path):
    """nvcc.log → {"source:kernel": ptxas's stack / spill and register
    lines}, in the log's order; a fused instantiation's kernel is named
    pt_fused<geometry, specular, pbr, prims>."""
    out, name, src = {}, None, "?"
    for line in open(log_path).read().splitlines():
        if line.startswith("== "):
            src = line[3:].split(".")[0]
            continue
        m = _ENTRY.search(line)
        if m:
            f = _FUSED.search(m.group(1))
            name = f"{src}:" + ("pt_fused<{},{},{},{}>".format(*f.groups())
                                if f else m.group(1))
            out.setdefault(name, "")
        elif name and ("spill" in line or "Used" in line):
            out[name] = (out[name] + " " + line.split(":", 1)[-1].strip()
                         ).strip()
    return out


def outside_fused(lines):
    """ptxas_lines of the sources other than the fused kernel's →
    {source: [lines in order]} (kernel names in anonymous namespaces may be
    mangled per build path, so the lines are compared by position)."""
    out = {}
    for key, text in lines.items():
        src = key.split(":", 1)[0]
        if not src.startswith("pt_fused"):
            out.setdefault(src, []).append(text)
    return out


def fused_smem(geometry, m, np_, k, ni, group):
    """Dynamic shared bytes a block of the fused kernel (csrc/pt_fused.cuh
    launch_geometry): 16 floats a triangle, prim, material and instance
    (instances in the inst mode only), the light and camera rows, a group
    box of 8 floats each outside instances when group < m, two ints an
    instance range."""
    inst = geometry == "inst"
    ni = ni if inst else 0
    boxes = -(-m // group) if not inst and group < m else 0
    return 4 * (16 * (m + np_ + k + ni) + 16 + 32 + 8 * boxes) + 8 * ni


def blocks_per_sm(regs, smem, threads=FUSED_THREADS):
    """Resident blocks an SM of a kernel with `regs` registers a thread and
    `smem` shared bytes a block: the least of the register, warp, block and
    shared-memory limits (the occupancy calculator's rule)."""
    warps = -(-threads // WARP)
    warp_regs = -(-regs * WARP // REG_UNIT) * REG_UNIT
    return min(SM_REGS // warp_regs // warps, SM_WARPS // warps, SM_BLOCKS,
               SM_SMEM // (smem + BLOCK_SMEM_SYS))


_FUSED_KEY = re.compile(r"pt_fused<(\d),(\d),(\d),(\d)>$")


def build_figures(K, sizes, log_path):
    """ptxas's lines of every kernel (nvcc.log at log_path), and for each of
    the 32 fused instantiations its registers and spill-store bytes a
    thread and its blocks an SM at each scene's shared memory (`sizes`:
    name → _scene_sizes; blocks_per_sm)."""
    lines = ptxas_lines(log_path)
    modes = {code: name for name, code in K.GEOMETRY.items()}
    attrs = {}
    for key, text in lines.items():
        f = _FUSED_KEY.search(key)
        if not f:
            continue
        code, sp, pb, pr = (int(x) for x in f.groups())
        regs = int(re.search(r"Used (\d+) registers", text).group(1))
        static = re.search(r"(\d+) bytes smem", text)
        spill = re.search(r"(\d+) bytes spill stores", text)
        row = dict(registers=regs,
                   spill_store_bytes=int(spill.group(1)) if spill else 0)
        for sname, (m, np_, k, ni, group) in sizes.items():
            smem = fused_smem(modes[code], m, np_ if pr else 0, k, ni, group)
            row[f"blocks_sm_{sname}"] = blocks_per_sm(
                regs, smem + (int(static.group(1)) if static else 0))
        attrs[K.pt_fused_name(bool(sp), bool(pb), bool(pr), modes[code])] = row
    return dict(attrs=attrs, ptxas=lines)


def _scene_sizes(P, scene):
    """A scene's sizes for fused_smem: (m, prims, materials, instances,
    group size)."""
    return (scene.num_triangles, max(scene.prims.num, 1),
            scene.materials.num, len(P.fused_inst_ranges(scene)),
            P.fused_group_size(scene))


def time_launch(torch, fn, reps):
    """CUDA-event ms a launch of fn, mean of reps after one warm-up."""
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


def _same(a, b):
    """Two (radiance sum, ray count) results bit-equal."""
    import torch
    return (torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
            and a[1] == b[1])


def run(dev, parent=None, counts=False, reps=10, groups=(8, 16),
        names=SCENES + CUTOFF, emit=None):
    """The A/B (and with counts the counts) on `names` → {scene: row}. Raises SystemExit where two trees' or two group sizes'
    images or counts differ, or the path lengths do not sum to the kernel's
    count. emit(line) receives each JSON line."""
    import torch
    from optix_raytracer_tpu_torch import kernels as K
    from optix_raytracer_tpu_torch.wavefront import engine as E
    from optix_raytracer_tpu_torch.tools import knot_probe as KP
    from optix_raytracer_tpu_torch.wavefront import pallas_pt as P

    def say(obj):
        if emit is not None:
            emit(json.dumps(obj))

    K.lib()
    trees = [("this", "optix_raytracer_tpu_torch")]
    if parent is not None:
        KP.load_parent(parent)
        importlib.import_module("ort_parent.kernels").lib()
        trees.append(("parent", "ort_parent"))
    results = {}
    sub = torch.zeros((), dtype=torch.int64, device=dev)
    for name in names:
        scenes = {tree: make_scenes(pkg, dev, (name,)).get(name)
                  for tree, pkg in trees}
        scene, cam, w, h, spl, depth = scenes["this"]
        m = scene.num_triangles
        row = dict(dim=f"{w}x{h}", spl=spl, depth=depth, triangles=m,
                   kernel=K.pt_fused_name(*P.fused_variant(scene)),
                   group=P.fused_group_size(scene))
        fns, first = {}, {}
        for tree, pkg in trees:
            if scenes[tree] is None:
                continue
            T = importlib.import_module(pkg + ".wavefront.pallas_pt")
            sc, cm = scenes[tree][:2]
            fns[tree] = (lambda T=T, sc=sc, cm=cm, **kw: T.render_sum_fused(
                sc, cm, w, h, sub, samples_per_launch=spl, max_depth=depth,
                **kw))
            rad, count = fns[tree]()
            first[tree] = (rad, int(count))
        row["rays"] = first["this"][1]
        if "parent" in first:
            if not _same(first["this"], first["parent"]):
                raise SystemExit(f"{name}: this tree's image or ray count "
                                 f"differs from the parent's")
            row["parent_bit_equal"] = True
        sizes = ([] if P.fused_inst_ranges(scene)
                 else sorted({m} | {g for g in groups if g < m}))
        for g in sizes:
            rad, count = fns["this"](group=g)
            if not _same((rad, int(count)), first["this"]):
                raise SystemExit(f"{name}: group size {g} changes the image "
                                 f"or the ray count")
        if reps:
            order = (["parent", "this", "this", "parent"] if "parent" in fns
                     else ["this"])
            for tree in order:
                row.setdefault(f"{tree}_ms", []).append(
                    time_launch(torch, fns[tree], reps))
            for g in sizes:
                key = "whole_ms" if g == m else f"g{g}_ms"
                row[key] = time_launch(torch,
                                       lambda g=g: fns["this"](group=g), reps)
        if counts:
            seg, rays = path_lengths(scene, cam, w, h, 0, spl, depth)
            if int(rays.sum()) != row["rays"]:
                raise SystemExit(f"{name}: the path lengths' rays "
                                 f"{int(rays.sum())} != the kernel's "
                                 f"{row['rays']}")
            row["warp_steps"] = {
                key: warp_steps(seg, warp_order(w, h, tiled))
                for key, tiled in (("rows", False), ("tiles", True))}
            closest, shadow, _ = record_queries(E, scene, cam, w, h, depth)
            row["tests_per_ray"] = triangle_test_counts(
                P, scene, closest, shadow, groups, w, h)
            row["sizes"] = _scene_sizes(P, scene)
        results[name] = row
        say({"scene": name, **row})
    if counts:
        sizes = {n: r["sizes"] for n, r in results.items()}
        figs = {}
        for tree, pkg in trees:
            TK = importlib.import_module(pkg + ".kernels")
            log = os.path.join(os.path.dirname(str(TK.build()[0])),
                               "nvcc.log")
            # the parent's kernel may not cull: its tables, no boxes
            figs[tree] = build_figures(TK, sizes if tree == "this" else {
                n: v[:4] + (v[0],) for n, v in sizes.items()}, log)
            say({"build": tree, **figs[tree]})
        results["build"] = figs
        if parent is not None:
            a = outside_fused(figs["this"]["ptxas"])
            b = outside_fused(figs["parent"]["ptxas"])
            if a != b:
                raise SystemExit(f"ptxas lines of the kernels outside the "
                                 f"fused kernel changed: {a} against {b}")
            say({"ptxas_unchanged_outside_fused": {k: len(v)
                                                   for k, v in a.items()}})
    return results


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--counts", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--group", default="8,16")
    ap.add_argument("--scene", default=",".join(SCENES + CUTOFF))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_fused: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    results = run(dev, parent=args.parent, counts=args.counts,
                  reps=args.reps,
                  groups=tuple(int(g) for g in args.group.split(",") if g),
                  names=tuple(n for n in args.scene.split(",") if n),
                  emit=lambda line: print(line, flush=True))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, results=results), f, indent=1)
    print(card)


if __name__ == "__main__":
    main()
