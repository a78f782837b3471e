"""A/B of the cluster walks: kernels 5c / 6c (--tier sc, the default) or
kernels 5 / 6 (--tier resident); with --cull, of the exact cull and the
octet cull (kernels 4 and 7) instead; with --queue, of the queue kernel
(kernel 8, resident tier) instead.

--tier sc builds chip_smoke.py's 4M knot (`knot_scene(1450, 1380)`,
4,002,002 triangles, the supercluster tier) and its eight phase-f ray sets:
tile-ordered primaries (interval cull), NEE shadow rays (exact cull) and the
six cluster queries of one sample-major strip (bounces 0-2, closest and
any-hit).

--tier resident builds chip_smoke.py's 25k knot (`knot_scene(200, 63)`,
25,202 triangles, the resident tier) and its ten phase-b sets: tile-ordered
primaries (interval cull), NEE shadow rays and the coherence-sorted bounce-1
wavefront (exact cull; bounce 1 also gated) and the six cluster queries of
one sample-major strip with the cull and gating the engine asks for; then
the 500k knot (`trefoil_mesh(1000, 250)`, the streaming tier) and its
phase-c primaries and shadow rays.

Per set it culls once and then:

- with --counts, prints the pair tests (ray x triangle slot) of the walks at
  four granularities (block union, 32-ray warp union, each ray's own
  crossings, needed) and under the admission rule (chip_smoke.py
  `sc_pair_counts` or `walk_pair_counts`, `walk_bound`), and the list
  entries per block;
- times the closest and the any-hit walk on all blocks (CUDA events, mean
  of --reps launches; --reps 0 times nothing). With --parent DIR it also
  times the walks of DIR's checkout of the port (loaded as its own package,
  its kernels built from its own sources) on the same lists, in the order
  parent, this tree, this tree, parent, and requires both trees' rows and
  occlusion to be bit-equal. With --windows W1,W2,... (resident) it times
  this tree's walks at each WALK_WINDOW (list entries a round) too.

With --cull the walks are not run: on each set whose cull is exact it holds
kernel 4 (on the supercluster facade at --tier sc) and, at the resident
tier, kernel 7 bit for bit to their plain versions, times them (CUDA
events, mean of --reps), with --parent DIR against DIR's kernels in the
order parent, this tree, this tree, parent (requiring tn / gm / om to be
bit-equal), and prints the set's cull counts and bounds
(knot_probe.cull_fields); with --k K1,K2,... it also times this tree's
kernels at each group size (clusters.cull_group) and prints the group
boxes crossed and the tests a live ray at each.

With --queue (resident tier) the walks are not run either: on chip_smoke.py's
phase-h sets (the 25k probe bounce-1 and NEE sets, the strip's queries
the queue answers: bounces 1-2 closest, bounces 0-2 NEE) and the 500k NEE
set (phase i) it builds the query's whole work list, holds kernel 8
(closest on closest sets, any-hit on NEE sets) bit for bit to its plain
version (on every k-th step past 4,096 steps) and to DIR's kernel 8 (all
steps), times both (parent, this, this, parent) and prints the set's
lane tests a step (tested / admitted / needed) and the queue's own floor
(knot_probe.queue_counts).

With --launches N it then times N launches of the tier's knot (1920x1088, 16
samples per launch, depth 3, after one warm-up; `knot_probe.launch_ab`):
sample-major, and at the resident tier also sequential (with --queue:
sample-major under ORT_QWALK=1) of this tree's engine and, with --parent,
of the parent's whole engine (parent, this, this, parent), and requires
equal first-launch rays. With --cull or --queue it
prints ptxas's registers and spills of kernels 4-8 of both trees.

    python -m optix_raytracer_tpu_torch.tools.bench_sc_walks [--tier sc]
        [--parent DIR] [--counts] [--reps 10] [--windows 2,4,8]
        [--cull] [--k 4,8,16,32] [--queue] [--launches 1] [--out FILE]

Needs a CUDA device. Prints one JSON line per set and one for the launches,
then the card's name and power limit; --out also writes them as one JSON
file.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import inspect
import json
import os
import subprocess
import time

import torch

from optix_raytracer_tpu_torch import kernels
from optix_raytracer_tpu_torch.accel import clusters as C
from optix_raytracer_tpu_torch.accel import qwalk as Q
from optix_raytracer_tpu_torch.tools import knot_probe as KP


def resident_walks(M):
    """Module M's kernels 5 / 6 as (closest, any), each called as
    fn(counts, lists, tnear, comp, aabb, packed, gate); a tree whose walks
    take no cluster boxes gets none."""
    def bind(fn):
        if "aabb" in inspect.signature(fn).parameters:
            return fn
        return lambda c, l, t, comp, aabb, p, g: fn(c, l, t, comp, p, g)
    return bind(M.walk_closest), bind(M.walk_any)


def sc_tier(dev):
    """The 4M knot and its phase-f sets → (scene, camera, configuration,
    [(table, the table the cull runs on, member boxes, [(name, rays,
    exact, gated)])])."""
    from optix_raytracer_tpu_torch.scene.builtins import (knot_camera,
                                                         knot_scene)
    K = KP.KNOT_SC
    scene = knot_scene(K["segments"], K["sides"], device=dev)
    W, H = K["width"], K["height"]
    prim, shadow, _ = KP.knot_ray_sets(scene, W, H, dev)
    cam = knot_camera(W, H).params(dev)
    closest_calls, any_calls = KP.main_path_strip_sets(scene, cam, W, H,
                                                      K["spl"], K["depth"])
    sets = [("primary", prim, False, False), ("shadow", shadow, True, False)]
    for bounce, ((rc, ec, _), (ra, ea, _)) in enumerate(
            zip(closest_calls, any_calls)):
        sets += [(f"strip_bounce{bounce}", rc, ec, False),
                 (f"strip_bounce{bounce}_shadow", ra, ea, False)]
    cull_aabb, member, n_sc = C._sc_tables(scene.clusters)
    facade = C._sc_facade(scene.clusters, cull_aabb, n_sc)
    return scene, cam, K, [(scene.clusters, facade, member, sets)]


def resident_tier(dev):
    """The 25k knot's phase-b sets and the 500k knot's phase-c sets, as
    sc_tier returns them (no member boxes)."""
    from optix_raytracer_tpu_torch.accel import native
    from optix_raytracer_tpu_torch.accel.geometry import (
        build_triangle_geometry)
    from optix_raytracer_tpu_torch.scene.builtins import (knot_camera,
                                                         knot_scene,
                                                         trefoil_mesh)
    K = KP.KNOT
    scene = knot_scene(K["segments"], K["sides"], device=dev)
    W, H = K["width"], K["height"]
    prim, shadow, bounce1 = KP.knot_ray_sets(scene, W, H, dev)
    sets = [("primary", prim, False, False), ("shadow", shadow, True, False),
            ("bounce1", bounce1, True, False),
            ("bounce1_gated", bounce1, True, True)]
    cam = knot_camera(W, H).params(dev)
    closest_calls, any_calls = KP.main_path_strip_sets(scene, cam, W, H,
                                                      K["spl"], K["depth"])
    for bounce, ((rc, ec, gc), (ra, ea, ga)) in enumerate(
            zip(closest_calls, any_calls)):
        sets += [(f"strip_bounce{bounce}", rc, ec, ec and gc),
                 (f"strip_bounce{bounce}_shadow", ra, ea, ga)]
    verts, idx, normals = trefoil_mesh(KP.KNOT_STREAM["segments"],
                                       KP.KNOT_STREAM["sides"])
    geom = build_triangle_geometry(verts, idx, dev, normals=normals)
    big = C.build_clusters(geom, order=native.sah_leaf_order(geom))
    bprim, bshadow, _ = KP.knot_ray_sets(
        dataclasses.replace(scene, clusters=big), W, H, dev)
    big_sets = [("knot500k_primary", bprim, False, False),
                ("knot500k_shadow", bshadow, True, False)]
    return scene, cam, K, [(scene.clusters, scene.clusters, None, sets),
                           (big, big, None, big_sets)]


def ab_ms(fn, pfn, reps):
    """fn's time and, with a parent's pfn, pfn's, CUDA events, mean of
    reps, in the order parent, this, this, parent → (this [ms], parent
    [ms] or None)."""
    if pfn is None:
        return [KP.cuda_ms(fn, reps)], None
    p1 = KP.cuda_ms(pfn, reps)
    c1, c2 = KP.cuda_ms(fn, reps), KP.cuda_ms(fn, reps)
    return [c1, c2], [p1, KP.cuda_ms(pfn, reps)]


def bits(*ts):
    return [t.view(torch.int32) for t in ts]


def cull_row(cl, packed, with_oct, P, PQ, ks, reps):
    """Kernel 4 (up to MAX_CLUSTERS columns) and kernel 7 (with_oct) on one
    set: bit-equal to the plain version and to the parent's, timed (ab_ms),
    at each group size of ks too, with the set's cull counts and
    bounds."""
    n_blocks, c_pad = packed.shape[0] // C.SUB, cl.c_pad
    row = {}
    culls = []
    if c_pad <= C.MAX_CLUSTERS:     # the streaming tier's cull is interval
        culls.append(("cull", 8, lambda M: M.exact_cull(
            cl.aabb, packed, n_blocks, c_pad), C.exact_cull_plain(
                cl.aabb, packed, n_blocks, c_pad), P))
    if with_oct:
        culls.append(("oct", 4, lambda M: M._oct_cull(cl, packed, n_blocks,
                                                     c_pad),
                      Q.oct_cull_plain(cl.aabb, packed, n_blocks, c_pad), PQ))
    for tag, out_bytes, run, plain, parent in culls:
        own = C if tag == "cull" else Q
        plain = plain if isinstance(plain, tuple) else (plain,)

        def check(out, who):
            out = out if isinstance(out, tuple) else (out,)
            if not all(torch.equal(a, b)
                       for a, b in zip(bits(*out), bits(*plain))):
                raise SystemExit(f"{tag}: {who} differs from the plain "
                                 f"version")
        check(run(own), "this tree")
        if parent is not None:
            check(run(parent), "the parent")
        row[f"{tag}_ms"], row[f"{tag}_parent_ms"] = ab_ms(
            lambda: run(own), None if parent is None else (lambda: run(parent)),
            reps)
        row.update(KP.cull_fields(cl.aabb, packed, out_bytes, tag))
        keep = C.cull_group
        try:
            for k in ks:
                C.cull_group = lambda c_pad, k=k: k
                check(run(own), f"group {k}")
                row[f"{tag}_ms_k{k}"] = KP.cuda_ms(lambda: run(own), reps)
                row.update({f"{f}_k{k}": v for f, v in KP.cull_fields(
                    cl.aabb, packed, out_bytes, tag, k).items()
                    if f.endswith(("groups_crossed_per_ray",
                                   "tests_per_ray"))})
        finally:
            C.cull_group = keep
    return row


def ptxas(K, names):
    """ptxas's report (registers, shared memory, spills) of the kernels
    named by `names` in module K's build (this tree's or the parent's)."""
    return KP.ptxas_report(K.build()[0].parent / "nvcc.log", names)


# chip_smoke.py's phase-h sets (the 25k sets the queue answers) and phase
# i's 500k NEE set, by resident_tier's names
QUEUE_SETS = ("bounce1", "shadow", "strip_bounce1", "strip_bounce2",
              "strip_bounce0_shadow", "strip_bounce1_shadow",
              "strip_bounce2_shadow", "knot500k_shadow")
PLAIN_QUEUE_STEPS = 4096     # as chip_smoke.py


def queue_run(Q_):
    """Module Q_'s kernel 8 as fn(closest, comp, steps, qrays, aabb); a tree
    whose kernel takes no cluster boxes gets none."""
    fn = Q_._run_queue
    if "aabb" in inspect.signature(fn).parameters:
        return fn
    return lambda closest, comp, steps, qrays, aabb=None: fn(
        closest, comp, steps, qrays)


def queue_row(cl, rays, closest, PQ, reps):
    """Kernel 8 on one set's whole work list: bit-equal to its plain
    version (every k-th step past PLAIN_QUEUE_STEPS) and to the parent's,
    timed (ab_ms), with the set's lane tests a step and the queue's own
    floor."""
    n, n_padded, packed, n_blocks, c_pad, k_cap = Q._prep(cl, rays, 6)
    om = Q._oct_cull(cl, packed, n_blocks, c_pad)
    n_items = Q._build_queue(om, cl.num_clusters, n_padded, k_cap)[3]
    steps, work, _, _ = Q._build_queue(om, cl.num_clusters, n_padded,
                                       -(-n_items // Q.ITEMS) * Q.ITEMS)
    qrays, _ = Q._marshal(packed, work[:n_items], n_padded)
    live = steps[:, :n_items // Q.ITEMS].contiguous()
    n_steps = live.shape[1]
    stride = max(1, -(-n_steps // PLAIN_QUEUE_STEPS))
    sub = live[:, ::stride].clone()
    sub[1] = torch.arange(sub.shape[1], dtype=torch.int32,
                          device=sub.device)
    plain = (Q.queue_closest_plain if closest else Q.queue_any_plain)(
        sub, qrays, cl.comp)
    own = queue_run(Q)

    def run(fn):
        return fn(closest, cl.comp, live, qrays, cl.aabb)
    if not torch.equal(own(closest, cl.comp, sub, qrays, cl.aabb).view(
            torch.int32), plain.view(torch.int32)):
        raise SystemExit("queue: this tree's kernel 8 differs from the "
                         "plain version")
    out = run(own)
    theirs = None if PQ is None else queue_run(PQ)
    if theirs is not None and not torch.equal(run(theirs).view(torch.int32),
                                              out.view(torch.int32)):
        raise SystemExit("queue: kernel 8 differs from the parent's")
    row = dict(rays=int(rays.tmin.shape[0]), closest=closest,
               n_items=n_items, steps=n_steps,
               plain_steps=f"{sub.shape[1]} of {n_steps}",
               **KP.queue_counts(live, qrays, cl.aabb, n_items, closest))
    row["queue_ms"], row["queue_parent_ms"] = ab_ms(
        lambda: run(own), None if theirs is None else (lambda: run(theirs)),
        reps)
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tier", choices=("sc", "resident"), default="sc")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--counts", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--windows", default="")
    ap.add_argument("--cull", action="store_true")
    ap.add_argument("--k", default="")
    ap.add_argument("--queue", action="store_true")
    ap.add_argument("--launches", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_sc_walks: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    kernels.lib()
    P = PQ = None
    if args.parent:
        KP.load_parent(args.parent)
        P = importlib.import_module("ort_parent.accel.clusters")
        PQ = importlib.import_module("ort_parent.accel.qwalk")
        P.kernels.lib()
    ks = [int(k) for k in args.k.split(",") if k]
    if args.queue and (args.cull or args.tier != "resident"):
        raise SystemExit("bench_sc_walks: --queue runs at --tier resident, "
                         "without --cull")
    sc = args.tier == "sc"
    windows = [int(w) for w in args.windows.split(",") if w]
    t0 = time.perf_counter()
    scene, cam, K, tables = (sc_tier if sc else resident_tier)(dev)
    torch.cuda.synchronize()
    results = dict(card=card, tier=args.tier,
                   build_s=time.perf_counter() - t0, sets={})
    for cl, cull_cl, member, sets in tables:
        for name, rays, exact, gate in sets:
            if args.queue:
                if name in QUEUE_SETS:
                    results["sets"][name] = row = queue_row(
                        cl, rays, not name.endswith("shadow"), PQ, args.reps)
                    print(json.dumps({"set": name, **row}), flush=True)
                continue
            packed = C._pack_rays(rays, C._padded(rays.tmin.shape[0]))
            n_blocks = packed.shape[0] // C.SUB
            if args.cull:
                if exact:
                    results["sets"][name] = row = cull_row(
                        cull_cl, packed, not sc, P, PQ, ks, args.reps)
                    print(json.dumps({"set": name, **row}), flush=True)
                continue
            culled = C._cull(cull_cl, packed, packed.shape[0] // C.SUPER,
                             cull_cl.c_pad, exact=exact)
            counts, lists, tnear = (t.reshape(n_blocks, -1) for t in culled)
            if sc:
                full = (counts, lists, tnear, cl.comp, member, packed)
                walks = dict(closest=C.walk_sc_closest, any=C.walk_sc_any)
                pwalks = (None if P is None else
                          dict(closest=P.walk_sc_closest, any=P.walk_sc_any))
            else:
                full = (counts, lists, tnear, cl.comp, cl.aabb, packed, gate)
                walks = dict(zip(("closest", "any"), resident_walks(C)))
                pwalks = (None if P is None else
                          dict(zip(("closest", "any"), resident_walks(P))))
            row = dict(rays=int(rays.tmin.shape[0]), exact=exact, gated=gate,
                       entries_per_block=int(counts.sum()) / n_blocks)
            out = {w: fn(*full) for w, fn in walks.items()}
            for w, fn in walks.items():
                pfn = None if pwalks is None else pwalks[w]
                if pfn is not None and not torch.equal(
                        out[w].view(torch.int32),
                        pfn(*full).view(torch.int32)):
                    raise SystemExit(f"{name}: {w} walk differs from the "
                                     f"parent's")
                if args.reps:
                    row[f"{w}_ms"], parent_ms = ab_ms(
                        lambda: fn(*full),
                        None if pfn is None else (lambda: pfn(*full)),
                        args.reps)
                    if parent_ms is not None:
                        row[f"{w}_parent_ms"] = parent_ms
                if args.reps and windows and not sc:
                    keep = C.WALK_WINDOW
                    try:
                        for win in windows:
                            C.WALK_WINDOW = win
                            if not torch.equal(fn(*full).view(torch.int32),
                                               out[w].view(torch.int32)):
                                raise SystemExit(f"{name}: {w} walk at "
                                                 f"window {win} differs")
                            row[f"{w}_ms_window{win}"] = KP.cuda_ms(
                                lambda: fn(*full), args.reps)
                    finally:
                        C.WALK_WINDOW = keep
            if args.counts:
                for w, closest in (("closest", True), ("any", False)):
                    if sc:
                        if closest == name.endswith("shadow"):
                            continue      # phase f counts the set's own walk
                        pairs = KP.sc_pair_counts(counts, lists, member,
                                                 packed, out[w], closest)
                        boxes, width = member, member.shape[2]
                    else:
                        pairs = KP.walk_pair_counts(counts, lists, cl.aabb,
                                                   packed, out[w], closest,
                                                   gate)
                        boxes, width = C._aabb_rows(cl)[:, :, None], 0
                    row.update({f"{w}_pairs_{k}": v
                                for k, v in pairs.items()})
                    row[f"{w}_pairs_needed"] = KP.walk_bound(
                        counts, lists, boxes, cl.num_clusters, packed,
                        out[w], closest, sc=width)["pairs"]
            results["sets"][name] = row
            print(json.dumps({"set": name, **row}), flush=True)
    del tables
    if args.cull or args.queue:
        names = ("cull_exact", "cluster_walk", "qwalk")
        results["ptxas"] = ptxas(kernels, names)
        if P is not None:
            results["ptxas_parent"] = ptxas(P.kernels, names)
        print(json.dumps({k: v for k, v in results.items()
                          if k.startswith("ptxas")}), flush=True)
    if args.launches:
        torch.cuda.empty_cache()
        launch = KP.launch_ab(
            dev, args.parent,
            ("knot25k_queue",) if args.queue else ("knot4m_auto",) if sc
            else ("knot25k_auto", "knot25k_sequential"), args.launches)
        results["launch"] = launch
        print(json.dumps({"launch": launch}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(card)


if __name__ == "__main__":
    main()
