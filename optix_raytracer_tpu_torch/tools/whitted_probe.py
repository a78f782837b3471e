"""The Whitted path's configurations and probes, shared by chip_smoke.py and
the tests: the two frames the apps render by default (the Whitted scene,
and the meshviewer's headlight rig on the 25k knot), a context that swaps
the query kernels (1-2, 4-6) and the counter RNG's kernels for their plain
versions, and a recorder of the rays the Whitted path hands them.
"""
from __future__ import annotations

import contextlib

from ..accel import clusters as C
from ..accel import pallas_bf
from ..core import rng

# apps/whitted.py main()'s defaults: 768x576, 16 samples, depth 6
WHITTED = dict(width=768, height=576, spl=16, depth=6)
# apps/meshviewer.py: render()'s frame and depth, main()'s 8 samples, on
# knot_scene(200, 63)'s geometry (25,202 triangles)
KNOT_RIG = dict(segments=200, sides=63, width=768, height=768, spl=8,
                depth=3)


@contextlib.contextmanager
def plain_queries():
    """Within the context the wrappers of kernels 1-2 (brute force), 4-6
    (the exact cull and the resident walks) and the counter RNG (`rng.seed`
    / `rng.uniform2`) run their plain versions on every device, with the
    same outputs bit for bit: a render through them is the kernels' oracle
    and launches nothing."""
    saved = {(pallas_bf, "closest_hit"): pallas_bf.closest_hit,
             (pallas_bf, "any_hit"): pallas_bf.any_hit,
             (C, "exact_cull"): C.exact_cull,
             (C, "walk_closest"): C.walk_closest,
             (C, "walk_any"): C.walk_any,
             (rng, "seed"): rng.seed, (rng, "uniform2"): rng.uniform2}

    def bf_closest(tri_consts, tri_mat, rays, chunk_size=65536, boxes=None):
        return pallas_bf.closest_hit_plain(tri_consts, tri_mat, rays,
                                           chunk_size)

    def bf_any(tri_consts, rays, chunk_size=65536, boxes=None):
        return pallas_bf.any_hit_plain(tri_consts, rays, chunk_size)

    try:
        pallas_bf.closest_hit, pallas_bf.any_hit = bf_closest, bf_any
        C.exact_cull = C.exact_cull_plain
        C.walk_closest, C.walk_any = C.walk_closest_plain, C.walk_any_plain
        rng.seed, rng.uniform2 = rng.seed_plain, rng.uniform2_plain
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


@contextlib.contextmanager
def recorded_queries():
    """Record every query the scene hands brute force (kernels 1-2) and the
    cluster walks (kernels 4-6; not the queue of ORT_QWALK=1) → a list,
    filled in call order, of dicts
    (kind "closest" / "any", route "bf" / "clusters", rays, for brute force
    the table (tri_consts, and tri_mat for a closest query), for the
    cluster table the ClusterSet, exact and group_walk)."""
    calls = []
    saved = dict(bf_closest=pallas_bf.closest_hit, bf_any=pallas_bf.any_hit,
                 cl_closest=C.closest_hit, cl_any=C.any_hit)

    def bf_closest(tri_consts, tri_mat, rays, **kw):
        calls.append(dict(kind="closest", route="bf", rays=rays,
                          tri_consts=tri_consts, tri_mat=tri_mat))
        return saved["bf_closest"](tri_consts, tri_mat, rays, **kw)

    def bf_any(tri_consts, rays, **kw):
        calls.append(dict(kind="any", route="bf", rays=rays,
                          tri_consts=tri_consts))
        return saved["bf_any"](tri_consts, rays, **kw)

    def cl_closest(cl, rays, exact=False, group_walk=False):
        calls.append(dict(kind="closest", route="clusters", rays=rays,
                          cl=cl, exact=exact, group_walk=group_walk))
        return saved["cl_closest"](cl, rays, exact=exact,
                                   group_walk=group_walk)

    def cl_any(cl, rays, exact=False, group_walk=False):
        calls.append(dict(kind="any", route="clusters", rays=rays,
                          cl=cl, exact=exact, group_walk=group_walk))
        return saved["cl_any"](cl, rays, exact=exact, group_walk=group_walk)

    try:
        pallas_bf.closest_hit, pallas_bf.any_hit = bf_closest, bf_any
        C.closest_hit, C.any_hit = cl_closest, cl_any
        yield calls
    finally:
        pallas_bf.closest_hit, pallas_bf.any_hit = (saved["bf_closest"],
                                                    saved["bf_any"])
        C.closest_hit, C.any_hit = saved["cl_closest"], saved["cl_any"]
