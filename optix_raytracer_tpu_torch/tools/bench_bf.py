"""A/B and counts of the brute-force kernels (kernels 1 and 2,
`csrc/bf.cu`).

Sets (--set, comma-separated; all by default), each a list of the kernel
calls the main path makes, recorded at `bruteforce.intersect_closest` /
`intersect_any` (the geometry or instance slice, the flat rays, the
material ids and the group boxes the query passes):

- `cornell_camera` / `cornell_shadow`: 1920x1088 jittered Cornell camera
  rays of subframe 0 and NEE-style shadow rays from their hits toward the
  light's centre (`camera_and_shadow_rays`, chip_smoke.py's phase-6 sets);
- `cornell_b{k}` / `cornell_b{k}_shadow` (k = 0-3): the wavefront's closest
  and shadow queries of bounce k of its first sample (subframe 0) on the
  Cornell box at the headline frame, depth 4: mixed liveness, incoherent
  past bounce 0;
- `knot_b{k}` / `knot_b{k}_shadow` (k = 0-2): the same on the smooth knot
  `knot_scene(16, 15)` (482 triangles), depth 3;
- `inst_b{k}` / `inst_b{k}_shadow` (k = 0-3): the same on the instanced
  Cornell box, three calls a query (one per instance slice, rays in the
  instance's object space);
- `random700` / `random700_shadow`: tests/test_torch_gpu.py's random
  700-triangle mesh (past the fused kernel's 512) under 2,088,960 random
  rays (all live), closest and any-hit;
- `cut{m}` / `cut{m}_shadow` (`--set cutoff` names them all; not run by
  default): the culling cutoff's meshes, bench_fused's CUTOFF_KNOTS
  (knot_scene of m = 10 to 482 triangles), every closest or every shadow
  query of the wavefront's first sample at the smooth knot's frame,
  bounces 0-2, as one set: with --whole, culled against whole at each m.

Per set it holds this tree's kernel to its plain version bit for bit (ids,
t, uv, normals; occlusion) and times it (CUDA events, mean of --reps
passes over the set's calls after a warm-up; --reps 0 times nothing), and
the host time a pass takes to issue its calls (`host_ms`: where it is
near the device time, the set's time is the host's).
With --parent DIR it also loads DIR's checkout of the port as its own
package `ort_parent` (its kernels built from its own sources), requires
its outputs on every call to be bit-equal to this tree's, and times the
two in the order parent, this tree, this tree, parent; a parent whose
wrappers take `boxes` gets its own `tri_groups.bf_group_boxes` of the
call's geometry (none where that tree does not cull). With --whole it
also times this tree with the table tested whole, without boxes
(bit-equal too).

It prints per set the live rays, the triangle and slab tests a live ray
makes in the culled loop (`pallas_bf._group_walk`: a group's triangles
where the ray's slab test crosses its box, up to the first occluder for
any-hit), and the bounds (`bf_bounds`): the needed work (closest: the
tests of the groups whose boxes cross the ray's window up to its winner,
and one slab test a group; any-hit: one test an occluded ray, the crossed
groups' tests and the slab tests for the others), brute force's (every live
ray against every triangle; one test an occluded ray) and, with --counts,
the issue floor of the tests from the kernels' SASS (`sass_counts`:
instructions and shared-memory loads a test in the innermost test loop of
each instantiation, from `cuobjdump -sass`), with ptxas's registers and
spills of both trees.

With --launches NAME,... (and --parent) it then times whole launches of
this tree's engine against the parent's (`knot_probe.launch_ab`: each
tree's own kernels and builders; one warm-up, then one timed launch each,
parent, this, this, parent; first-launch rays equal): chip_smoke.py's
Cornell headline through the fused kernel (`cornell_auto`, phase 6) and
the wavefront (`cornell_wavefront`, kernels 1-2), the 25k knot
sample-major (`knot25k_auto`) and sequential (`knot25k_sequential`, phase
d) and under ORT_QWALK=1 (`knot25k_queue`, phase j), and the 4M knot
(`knot4m_auto`, phase g); `--set ""` skips the kernel sets.

    python -m optix_raytracer_tpu_torch.tools.bench_bf [--parent DIR]
        [--counts] [--reps 10] [--whole] [--set cornell_camera,...]
        [--launches cornell_auto,...] [--out FILE]

Needs a CUDA device. Prints one JSON line per set (and per build), then
the card's name and power limit; --out also writes them as one JSON file.
`camera_and_shadow_rays`, `make_sets`, `bf_bounds` and `sass_counts` also
serve chip_smoke.py's phases 2 and 6.
"""
from __future__ import annotations

import argparse
import importlib
import inspect
import json
import os
import re
import shutil
import subprocess
import time

import numpy as np
import torch

from .. import kernels
from ..accel import bruteforce
from ..accel import pallas_bf as PB
from ..accel import tri_groups
from ..accel.geometry import build_triangle_geometry
from ..core.rays import Rays
from . import knot_probe as KP
from .bench_fused import CUTOFF_KNOTS
from .knot_probe import PAIR_OPS, RAY_BYTES, SLAB_OPS, bound, cuda_ms

# The H100 SXM's issue rate outside the tensor cores: 132 SMs, four warp
# instructions a clock each, at the 1,980 MHz boost clock.
SM_COUNT, ISSUE_PER_CLOCK, CLOCK_HZ = 132, 4, 1.98e9
# Bytes a ray's outputs take: t, prim, mat, uv, normal (closest); the
# occlusion flag, one bool (any-hit).
OUT_BYTES = dict(closest=32, any=1)
# Rays a chunk of the counts' torch loops.
COUNT_CHUNK = 1 << 18
SETS = ("cornell_camera", "cornell_shadow",
        *(f"cornell_b{k}{s}" for k in range(4) for s in ("", "_shadow")),
        *(f"knot_b{k}{s}" for k in range(3) for s in ("", "_shadow")),
        *(f"inst_b{k}{s}" for k in range(4) for s in ("", "_shadow")),
        "random700", "random700_shadow")
CUTOFF_SETS = tuple(f"cut{2 * a * b + 2}{s}" for a, b in CUTOFF_KNOTS
                    for s in ("", "_shadow"))


def random700(device, n):
    """tests/test_torch_gpu.py's random 700-triangle mesh (_mesh_and_rays:
    seed 7, one degenerate triangle) under n random rays, all live."""
    rng = np.random.default_rng(7)
    v0 = rng.uniform(-1, 1, (700, 3))
    verts = np.concatenate([v0, v0 + rng.uniform(-1, 1, (700, 3)),
                            v0 + rng.uniform(-1, 1, (700, 3))])
    idx = np.arange(3 * 700).reshape(3, 700).T.copy()
    idx[350, 2] = idx[350, 1]
    geom = build_triangle_geometry(verts.astype(np.float32),
                                   idx.astype(np.int32), device)
    tri_mat = torch.as_tensor(rng.integers(0, 5, 700).astype(np.int32),
                              device=device)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays.make(torch.as_tensor(o, device=device),
                     torch.as_tensor(d, device=device), tmin=1e-3, tmax=50.0)
    return geom, tri_mat, rays


def camera_and_shadow_rays(scene, width, height, device):
    """Jittered Cornell camera rays of subframe 0, and NEE-style shadow rays
    from their closest hits toward the light's centre (a ray that misses
    gets tmax 0: dead)."""
    from ..core import rng as _rng
    from ..core.camera import generate_rays
    from ..scene.builtins import cornell_camera
    cam = cornell_camera(width, height).params(device)
    pix = torch.arange(width * height, dtype=torch.int64, device=device)
    state = _rng.seed(pix, 0).reshape(height, width)
    rays, _ = generate_rays(cam, width, height, rng_state=state)
    rays = rays.reshape(width * height)
    hits = PB.closest_hit_plain(scene.geom.tri_consts, scene.tri_mat, rays)
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


def record_calls(scene, cam, width, height, depth):
    """The kernel calls of the wavefront's first sample (subframe 0): per
    closest and shadow query of bounce k, every brute-force call it makes
    (one a query; one per instance with instances) → {"b{k}": [call],
    "b{k}_shadow": [call]}, a call dict(kind, geom, rays, tri_mat,
    boxes)."""
    from ..wavefront import engine as E
    out, label = {}, {}
    query = dict(scene_closest=E.scene_closest, scene_any=E.scene_any)
    kernel = dict(intersect_closest=bruteforce.intersect_closest,
                  intersect_any=bruteforce.intersect_any)
    count = dict(scene_closest=0, scene_any=0)

    def at_query(name):
        def call(sc, rays, *args, **kw):
            k = count[name]
            count[name] += 1
            label["now"] = f"b{k}" + ("_shadow" if name == "scene_any" else "")
            return query[name](sc, rays, *args, **kw)
        return call

    def at_kernel(name):
        def call(geom, rays, *args, **kw):
            flat = rays.reshape(rays.tmin.numel())
            kind = "closest" if name == "intersect_closest" else "any"
            tri_mat = kw.get("tri_mat")
            if kind == "closest" and tri_mat is None:
                tri_mat = torch.zeros((geom.num_triangles,),
                                      dtype=torch.int32, device=flat.device)
            out.setdefault(label["now"], []).append(dict(
                kind=kind, geom=geom, rays=flat, tri_mat=tri_mat,
                boxes=kw.get("boxes")))
            return kernel[name](geom, rays, *args, **kw)
        return call

    try:
        for name in query:
            setattr(E, name, at_query(name))
        for name in kernel:
            setattr(bruteforce, name, at_kernel(name))
        E.render_sample(scene, cam, width, height, 0, max_depth=depth)
    finally:
        for name, fn in query.items():
            setattr(E, name, fn)
        for name, fn in kernel.items():
            setattr(bruteforce, name, fn)
    return out


def make_sets(dev, names):
    """{set name: [call]} for the sets of `names` (SETS, CUTOFF_SETS)."""
    from ..scene import builtins as B
    w, h, _, depth = B.HEADLINE_FRAME
    sets = {}
    for a, b in CUTOFF_KNOTS:
        m = 2 * a * b + 2
        if not {f"cut{m}", f"cut{m}_shadow"} & set(names):
            continue
        fw, fh, _, fdepth = B.SMOOTH_KNOT_FRAME
        recorded = record_calls(B.knot_scene(a, b, device=dev),
                                B.knot_camera(fw, fh).params(dev), fw, fh,
                                fdepth)
        for shadow in ("", "_shadow"):
            sets[f"cut{m}{shadow}"] = [
                c for k, v in sorted(recorded.items())
                if k.endswith("_shadow") == bool(shadow) for c in v]

    def call(kind, geom, rays, tri_mat=None):
        if tri_mat is None:
            tri_mat = torch.zeros((geom.num_triangles,), dtype=torch.int32,
                                  device=dev)
        return dict(kind=kind, geom=geom, rays=rays, tri_mat=tri_mat,
                    boxes=tri_groups.bf_group_boxes(geom))

    wanted = set(names)
    if wanted & {"cornell_camera", "cornell_shadow"}:
        scene = B.cornell_box(dev)
        cam_rays, shadow = camera_and_shadow_rays(scene, w, h, dev)
        sets["cornell_camera"] = [call("closest", scene.geom, cam_rays,
                                       scene.tri_mat)]
        sets["cornell_shadow"] = [call("any", scene.geom, shadow)]
    for prefix, make, cam_of, frame in (
            ("cornell", B.cornell_box, B.cornell_camera, B.HEADLINE_FRAME),
            ("knot", lambda d: B.knot_scene(*B.SMOOTH_KNOT_MESH, device=d),
             B.knot_camera, B.SMOOTH_KNOT_FRAME),
            ("inst", B.cornell_box_instanced, B.cornell_camera,
             B.HEADLINE_FRAME)):
        mine = [n for n in names if n.startswith(prefix + "_b")]
        if not mine:
            continue
        fw, fh, _, fdepth = frame
        recorded = record_calls(make(dev), cam_of(fw, fh).params(dev), fw,
                                fh, fdepth)
        for n in mine:
            if n[len(prefix) + 1:] in recorded:
                sets[n] = recorded[n[len(prefix) + 1:]]
    if wanted & {"random700", "random700_shadow"}:
        geom, tri_mat, rays = random700(dev, w * h)
        sets["random700"] = [call("closest", geom, rays, tri_mat)]
        sets["random700_shadow"] = [call("any", geom, rays)]
    return {n: sets[n] for n in names if n in sets}


def run_call(M, c, boxes, **kw):
    """Module M's kernel (pallas_bf) on one recorded call."""
    tri = c["geom"].tri_consts
    if boxes is not None:
        kw["boxes"] = boxes
    if c["kind"] == "closest":
        return M.closest_hit(tri, c["tri_mat"], c["rays"], **kw)
    return M.any_hit(tri, c["rays"], **kw)


def same(a, b):
    """Two kernels' outputs (a dict or an occlusion plane), bit for bit."""
    if isinstance(a, dict):
        return all(torch.equal(a[k].view(torch.int32)
                               if a[k].dtype == torch.float32 else a[k],
                               b[k].view(torch.int32)
                               if b[k].dtype == torch.float32 else b[k])
                   for k in ("t", "prim_id", "mat_id", "uv", "normal"))
    return torch.equal(a, b)


def plain(c):
    tri = c["geom"].tri_consts
    if c["kind"] == "closest":
        return PB.closest_hit_plain(tri, c["tri_mat"], c["rays"])
    return PB.any_hit_plain(tri, c["rays"])


def bf_counts(c, out):
    """Per call: live rays and, per live ray, the culled loop's triangle
    and slab tests (pallas_bf._group_walk at the call's boxes; the whole
    table without), the needed tests and slabs, and brute force's tests,
    given the kernel's outputs `out` (the winner's t, the occlusion)."""
    g = c["geom"]
    tri, m, boxes = g.tri_consts, g.num_triangles, c["boxes"]
    group = tri_groups.FUSED_GROUP if boxes is not None else max(m, 1)
    r = c["rays"]
    closest = c["kind"] == "closest"
    end = out["t"] if closest else None
    occ = None if closest else out
    tot = dict(rays=r.tmin.numel(), live=0, tests=0, slabs=0, needed=0,
               needed_slabs=0, brute=0)
    for s in range(0, r.tmin.numel(), COUNT_CHUNK):
        e = min(s + COUNT_CHUNK, r.tmin.numel())
        o, d, tmin, tmax = (r.origin[s:e], r.direction[s:e], r.tmin[s:e],
                            r.tmax[s:e])
        live = tmax > tmin
        n_live = int(live.sum())
        tot["live"] += n_live
        _, _, tests, slabs, _ = PB._group_walk(tri, boxes, group, o, d, tmin,
                                               tmax, not closest)
        tot["tests"] += int(tests.sum())
        tot["slabs"] += int(slabs.sum())
        if closest:
            tot["brute"] += n_live * m
            hi = end[s:e]
            need = live
        else:
            oc = occ[s:e] & live
            tot["brute"] += int(oc.sum()) + int((live & ~oc).sum()) * m
            tot["needed"] += int(oc.sum())
            hi = tmax
            need = live & ~oc
        if boxes is None:
            tot["needed"] += int(need.sum()) * m
            continue
        g = boxes.shape[0]
        cross = tri_groups.fused_group_admitted_plain(o, d, tmin, hi, boxes)
        sizes = torch.full((g,), group, dtype=torch.int64, device=o.device)
        sizes[-1] = m - group * (g - 1)
        tot["needed"] += int(((cross & need[:, None]).to(torch.int64)
                              * sizes).sum())
        tot["needed_slabs"] += int(need.sum()) * g
    return tot


def bf_bounds(calls, outs, instr=None):
    """A set's counts (bf_counts summed over its calls) and bounds: the
    needed work's and brute force's (knot_probe.bound: FP32 operations of
    the tests and slabs against the bytes each ray and table moves), and
    with `instr` (sass_counts' instructions a test of the set's
    instantiation) the issue floor of the culled loop's tests."""
    tot = {}
    nbytes = 0
    for c, o in zip(calls, outs):
        for k, v in bf_counts(c, o).items():
            tot[k] = tot.get(k, 0) + v
        nbytes += (c["rays"].tmin.numel() * (RAY_BYTES + OUT_BYTES[c["kind"]])
                   + c["geom"].num_triangles * 68)
    live = max(tot["live"], 1)
    row = dict(rays=tot["rays"], live=tot["live"],
               tests_per_live_ray=tot["tests"] / live,
               slabs_per_live_ray=tot["slabs"] / live,
               needed_tests_per_live_ray=tot["needed"] / live,
               brute_tests_per_live_ray=tot["brute"] / live)
    need = bound(PAIR_OPS * tot["needed"] + SLAB_OPS * tot["needed_slabs"],
                 nbytes)
    brute = bound(PAIR_OPS * tot["brute"], nbytes)
    if need["bound_ms"] < brute["bound_ms"]:
        row["bound"] = dict(need, bound_brute_ms=brute["bound_ms"])
    else:
        row["bound"] = dict(brute, bound_brute_ms=brute["bound_ms"])
    if instr:
        row["issue_floor_ms"] = 1e3 * tot["tests"] * instr / 32 / (
            SM_COUNT * ISSUE_PER_CLOCK * CLOCK_HZ)
    return row


_BF = re.compile(r"(bf_kernelILb([01])E|bf_(closest|any)_kernel)")


def _cuobjdump():
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "cuobjdump")):
            return os.path.join(cand, "bin", "cuobjdump")
    return shutil.which("cuobjdump")


def sass_counts(lib_path):
    """The innermost test loop of kernels 1 and 2 in a build's
    SASS (`cuobjdump -sass`): the loop (a backward branch's span) with the
    fewest instructions among those holding a MUFU.RCP and at least 18
    FMUL a reciprocal (a test's 21 products; the integer divisions'
    reciprocals have none), whose reciprocals count its tests →
    {"closest" or "any": dict(tests, instructions, lds, ldg,
    instr_per_test, lds_per_test, ldg_per_test)}: lds the shared-memory
    loads, ldg the global ones; {} without cuobjdump."""
    tool = _cuobjdump()
    if tool is None:
        return {}
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split("\n", 1)[0].strip()
        m = _BF.search(name)
        if not m:
            continue
        ins, labels = [], {}
        for ln in chunk.splitlines()[1:]:
            lab = re.match(r"\s*(\.L_x_\d+):", ln)
            if lab:
                labels[lab.group(1)] = len(ins)
                continue
            im = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
            if im:
                ins.append((int(im.group(1), 16), im.group(2).strip()))
        addr = {a: i for i, (a, _) in enumerate(ins)}
        loops = []
        for i, (_, op) in enumerate(ins):
            if not re.search(r"\bBRA\b", op):
                continue
            tgt = re.search(r"\(?(\.L_x_\d+)\)?", op)
            j = labels.get(tgt.group(1)) if tgt else None
            if j is None:
                hx = re.search(r"0x([0-9a-f]+)", op)
                j = addr.get(int(hx.group(1), 16)) if hx else None
            if j is not None and j <= i:
                body = [o for _, o in ins[j:i + 1]]
                rcp = sum(re.search(r"\bMUFU\.RCP\b", o) is not None
                          for o in body)
                fmul = sum(re.search(r"\bFMUL\b", o) is not None
                           for o in body)
                if rcp and fmul >= 18 * rcp:   # a test's 21 products
                    loops.append((len(body), rcp, sum(
                        re.search(r"\bLDS\b", o) is not None for o in body),
                        sum(re.search(r"\bLDG\b", o) is not None
                            for o in body)))
        if not loops:
            continue
        n, rcp, lds, ldg = min(loops)
        key = ("closest" if m.group(2) == "1" or m.group(3) == "closest"
               else "any")
        out[key] = dict(tests=rcp, instructions=n, lds=lds, ldg=ldg,
                        instr_per_test=n / rcp, lds_per_test=lds / rcp,
                        ldg_per_test=ldg / rcp)
    return out


def host_ms(fn, reps):
    """Mean host time fn() takes to issue its work (the device idle at the
    start, not waited for in between)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * dt / reps


def run(dev, parent=None, counts=False, reps=10, whole=False, names=SETS,
        emit=None):
    """The A/B on the sets of `names` → {set: row}; whole also times this
    tree with the table tested whole (no boxes). Raises
    SystemExit where a kernel's outputs differ from the plain version's or
    the parent's."""
    def say(obj):
        if emit is not None:
            emit(json.dumps(obj))

    kernels.lib()
    PP = PG = None
    if parent is not None:
        KP.load_parent(parent)
        importlib.import_module("ort_parent.kernels").lib()
        PP = importlib.import_module("ort_parent.accel.pallas_bf")
        if os.path.exists(os.path.join(parent, "optix_raytracer_tpu_torch",
                                       "accel", "tri_groups.py")):
            PG = importlib.import_module("ort_parent.accel.tri_groups")
        parent_boxes = "boxes" in inspect.signature(PP.closest_hit).parameters
    sass = sass_counts(kernels.build()[0]) if counts else {}
    if counts:
        log = kernels.build()[0].parent / "nvcc.log"
        build = dict(this_ptxas=KP.ptxas_report(log, ("bf_kernel",)),
                     this_sass=sass)
        if PP is not None:
            plib = importlib.import_module("ort_parent.kernels").build()[0]
            build["parent_ptxas"] = KP.ptxas_report(
                plib.parent / "nvcc.log", ("bf_kernel", "bf_closest_kernel",
                                           "bf_any_kernel"))
            build["parent_sass"] = sass_counts(plib)
        say({"build": build})
    results = {}
    for name, calls in make_sets(dev, names).items():
        outs = [run_call(PB, c, c["boxes"]) for c in calls]
        for c, o in zip(calls, outs):
            if not same(o, plain(c)):
                raise SystemExit(f"{name}: this tree's kernel differs from "
                                 f"the plain version")
        pboxes = None
        if PP is not None:
            pboxes = [PG.bf_group_boxes(c["geom"])
                      if parent_boxes and PG is not None else None
                      for c in calls]
            for c, o, b in zip(calls, outs, pboxes):
                if not same(run_call(PP, c, b), o):
                    raise SystemExit(f"{name}: the parent's kernel differs "
                                     f"from this tree's")
        kind = calls[0]["kind"]
        instr = sass.get(kind, {})
        row = dict(calls=len(calls), kind=kind,
                   triangles=calls[0]["geom"].num_triangles,
                   culled=calls[0]["boxes"] is not None,
                   **bf_bounds(calls, outs, instr.get("instr_per_test")))
        if PP is not None:
            row["parent_bit_equal"] = True

        def this(culled=True):
            for c in calls:
                run_call(PB, c, c["boxes"] if culled else None)

        def theirs():
            for c, b in zip(calls, pboxes):
                run_call(PP, c, b)
        if reps:
            if PP is None:
                row["this_ms"] = [cuda_ms(this, reps)]
            else:
                p1 = cuda_ms(theirs, reps)
                row["this_ms"] = [cuda_ms(this, reps), cuda_ms(this, reps)]
                row["parent_ms"] = [p1, cuda_ms(theirs, reps)]
                row["parent_host_ms"] = host_ms(theirs, reps)
            row["host_ms"] = host_ms(this, reps)
            if whole and calls[0]["boxes"] is not None:
                for c, o in zip(calls, outs):
                    if not same(run_call(PB, c, None), o):
                        raise SystemExit(f"{name}: the table tested whole "
                                         f"changes the outputs")
                row["whole_ms"] = cuda_ms(lambda: this(False), reps)
        results[name] = row
        say({"set": name, **row})
    return results


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--counts", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--whole", action="store_true")
    ap.add_argument("--set", default=",".join(SETS))
    ap.add_argument("--launches", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_bf: needs a CUDA device")
    if args.launches and args.parent is None:
        raise SystemExit("bench_bf: --launches needs --parent")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    results = run(dev, parent=args.parent, counts=args.counts,
                  reps=args.reps, whole=args.whole,
                  names=tuple(m for n in args.set.split(",") if n
                              for m in (CUTOFF_SETS if n == "cutoff"
                                        else (n,))),
                  emit=lambda line: print(line, flush=True))
    if args.launches:
        results["launches"] = KP.launch_ab(
            dev, args.parent,
            tuple(n for n in args.launches.split(",") if n))
        print(json.dumps({"launches": results["launches"]}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, results=results), f, indent=1)
    print(card)


if __name__ == "__main__":
    main()
