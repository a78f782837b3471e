"""A/B of the supercluster walks (kernels 5c / 6c) on the 4M-triangle knot.

Builds chip_smoke.py's 4M knot (`knot_scene(1450, 1380)`, 4,002,002
triangles, the supercluster tier) and its eight phase-f ray sets: tile-ordered
primaries (interval cull), NEE shadow rays (exact cull) and the six cluster
queries of one sample-major strip (bounces 0-2, closest and any-hit). Per set
it culls once and then:

- with --counts, prints the pair tests (ray x triangle slot) of the walks at
  four granularities (block union, 32-ray warp union, each ray's own member
  crossings, needed) and under the admission rule (chip_smoke.py
  `sc_pair_counts`, `walk_bound`);
- times kernel 5c and kernel 6c on all blocks (CUDA events, mean of --reps
  launches). With --parent DIR it also times the walks of DIR's checkout of
  the port (loaded as its own package, its kernels built from its own
  sources) on the same lists, in the order parent, this tree, this tree,
  parent, and requires both trees' rows and occlusion to be bit-equal.

With --launches N it then times N sample-major launches of the 4M knot
(1920x1088, 16 samples per launch, depth 3, after one warm-up) with this
tree's walks and, with --parent, with the parent's walks patched into the
same engine (parent, this, this, parent), and requires equal ray counts.

    python optix_raytracer_tpu_torch/tools/bench_sc_walks.py [--parent DIR]
        [--counts] [--reps 10] [--launches 1] [--out FILE]

Needs a CUDA device. Prints one JSON line per set and one for the launches,
then the card's name and power limit; --out also writes them as one JSON
file.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def load_parent(root):
    """DIR/optix_raytracer_tpu_torch as the package `ort_parent`."""
    pkg = os.path.join(root, "optix_raytracer_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "ort_parent", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["ort_parent"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("ort_parent.accel.clusters")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--counts", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--launches", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_sc_walks: needs a CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke as S
    from optix_raytracer_tpu_torch import kernels
    from optix_raytracer_tpu_torch.accel import clusters as C
    from optix_raytracer_tpu_torch.scene.builtins import (knot_camera,
                                                         knot_scene)
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    kernels.lib()
    P = load_parent(args.parent) if args.parent else None
    if P is not None:
        P.kernels.lib()
    K = S.KNOT_SC
    t0 = time.perf_counter()
    scene = knot_scene(K["segments"], K["sides"], device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cl = scene.clusters
    W, H, spl, depth = K["width"], K["height"], K["spl"], K["depth"]
    prim, shadow, _ = S.knot_ray_sets(scene, W, H, dev)
    cam = knot_camera(W, H).params(dev)
    closest_calls, any_calls = S.main_path_strip_sets(scene, cam, W, H, spl,
                                                      depth)
    sets = [("primary", prim, False), ("shadow", shadow, True)]
    for bounce, ((rc, ec, _), (ra, ea, _)) in enumerate(
            zip(closest_calls, any_calls)):
        sets += [(f"strip_bounce{bounce}", rc, ec),
                 (f"strip_bounce{bounce}_shadow", ra, ea)]
    cull_aabb, member, n_sc = C._sc_tables(cl)
    facade = C._sc_facade(cl, cull_aabb, n_sc)
    results = dict(card=card, build_s=build_s, sets={})
    for name, rays, exact in sets:
        packed = C._pack_rays(rays, C._padded(rays.tmin.shape[0]))
        n_blocks = packed.shape[0] // C.SUB
        culled = C._cull(facade, packed, packed.shape[0] // C.SUPER,
                         facade.c_pad, exact=exact)
        counts, lists, tnear = (t.reshape(n_blocks, -1) for t in culled)
        full = (counts, lists, tnear, cl.comp, member, packed)
        row = dict(rays=int(rays.tmin.shape[0]), exact=exact)
        walks = dict(closest=C.walk_sc_closest, any=C.walk_sc_any)
        out = {w: fn(*full) for w, fn in walks.items()}
        if P is not None:
            for w, fn in dict(closest=P.walk_sc_closest,
                              any=P.walk_sc_any).items():
                ref = fn(*full)
                if not torch.equal(out[w].view(torch.int32),
                                   ref.view(torch.int32)):
                    raise SystemExit(f"{name}: {w} walk differs from the "
                                     f"parent's")
                p1 = S.cuda_ms(lambda: fn(*full), args.reps)
                c1 = S.cuda_ms(lambda: walks[w](*full), args.reps)
                c2 = S.cuda_ms(lambda: walks[w](*full), args.reps)
                p2 = S.cuda_ms(lambda: fn(*full), args.reps)
                row[f"{w}_ms"] = [c1, c2]
                row[f"{w}_parent_ms"] = [p1, p2]
        else:
            for w, fn in walks.items():
                row[f"{w}_ms"] = [S.cuda_ms(lambda: fn(*full), args.reps)]
        if args.counts:
            closest = not name.endswith("shadow")
            res = out["closest" if closest else "any"]
            row["counted_walk"] = "closest" if closest else "any"
            row.update({f"pairs_{k}": v for k, v in S.sc_pair_counts(
                counts, lists, member, packed, res, closest).items()})
            row["pairs_needed"] = S.walk_bound(
                counts, lists, member, cl.num_clusters, packed, res, closest,
                sc=member.shape[2])["pairs"]
            row["entries"] = int(counts.sum())
        results["sets"][name] = row
        print(json.dumps({"set": name, **row}), flush=True)
    del closest_calls, any_calls, sets, prim, shadow
    if args.launches:
        own = (C.walk_sc_closest, C.walk_sc_any)
        trees = [("this", own)]
        if P is not None:
            trees = [("parent", (P.walk_sc_closest, P.walk_sc_any)),
                     ("this", own), ("this", own),
                     ("parent", (P.walk_sc_closest, P.walk_sc_any))]
        launch = dict()
        try:
            for tree, (wc, wa) in trees:
                C.walk_sc_closest, C.walk_sc_any = wc, wa
                (_, _, dt, _, _, first_rays, _, _) = S.timed_launches(
                    scene, cam, W, H, spl, depth, "auto", args.launches,
                    dev)
                launch.setdefault(f"{tree}_ms_per_launch", []).append(
                    1e3 * dt / args.launches)
                launch.setdefault(f"{tree}_first_launch_rays", []).append(
                    first_rays)
        finally:
            C.walk_sc_closest, C.walk_sc_any = own
        rays_seen = {r for k, v in launch.items() if k.endswith("_rays")
                     for r in v}
        if len(rays_seen) != 1:
            raise SystemExit(f"launch ray counts differ: {launch}")
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
