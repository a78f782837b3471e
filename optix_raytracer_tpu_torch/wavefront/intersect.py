"""Scene-level intersection (counterpart of `wavefront/intersect.py`):
the instance loop for a two-level scene (`accel/tlas.py`), the
cluster-culled traversal for a scene with a cluster table, the threaded-BVH
walk for a scene with a BVH past MAX_SMEM_TRIS triangles and no cluster
table (a mesh past the cluster tier's cap; `accel/traverse.py`, the walk
kernel on CUDA, which raises rather than fall back), brute force otherwise
(culled by the scene's group boxes, `DeviceScene.bf_boxes`),
then the custom prims merged in (`accel/primitives.py`; a prim
hit reports prim_id = num_triangles + its row), then on a scene with moving
triangles their hits at each ray's shutter time (`accel/motion.py`; prim_id
= num_triangles + prims.num + their row, mat_id from the scene's motion
table). `times` None means time 0, as in the reference: the Whitted
integrator and render_aovs pass none, so moving triangles stand at their
first key there.

Occlusion on a scene with alpha cutouts re-enters past the holes (the
anyhit program's optixIgnoreIntersection): with opacity micromaps, one
any-hit query over the certain-solid split (kernels 4 + 6 on its cluster
table, else kernel 2) and the re-entry loop over the unknown split alone
(kernel 1), each hit's micro-triangle state deciding before its mask;
without them, the loop over the whole scene. Each step of a loop ends in a
host sync (whether a ray is still unresolved), and a ray still unresolved
after `MAX_ALPHA_STEPS` steps counts as blocked, as in the reference. The
micromap path folds the moving triangles into its first query at the rays'
times (intersect.py:298-305); the loop without micromaps asks
scene_closest without times (intersect.py:360), so there they stand at time
0, as in the reference.

In the JAX package the cluster branch, and an instance's walk of its own
cluster table, run only on a TPU (intersect.py:95-96, 155-156); in the
port a cluster table alone selects them, on any device (the CPU runs the
kernels' plain versions). With ORT_QWALK=1 the cluster branch sends exact-cull
closest-hit queries and every any-hit query through the cluster-major queue
(`accel/qwalk.py`), as the reference does.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from .. import telemetry
from ..accel import bruteforce as bf
from ..accel import clusters as cluster_mod
from ..accel import motion as motion_mod
from ..accel import primitives as prim_mod
from ..accel import qwalk as qwalk_mod
from ..accel import tlas
from ..accel import traverse as trav
from ..accel.geometry import shading_frame
from ..accel.micromap import OPAQUE, TRANSPARENT, micro_index
from ..core.rays import Hits, Rays
from ..scene.device_scene import MAX_SMEM_TRIS, DeviceScene
from ..shade import materials as mats
from ..shade.texture import sample_bilinear

# The alpha loops' backstop (intersect.py:254, 372): past it an unresolved
# ray counts as blocked.
MAX_ALPHA_STEPS = 64
# How far a loop steps past a masked surface (intersect.py:324, 359).
ALPHA_STEP = 1e-2
# Host-side counts of the alpha loops: loops run and steps taken (each step
# one closest-hit query and one host sync); reset_alpha_stats zeroes them.
ALPHA_STATS = telemetry.counters("intersect.alpha", ("loops", "steps"))


def reset_alpha_stats():
    telemetry.reset_counters("intersect.alpha")


def _use_qwalk() -> bool:
    """The opt-in queue traversal (intersect.py:30-36): ORT_QWALK=1, read at
    call time."""
    return os.environ.get("ORT_QWALK", "0") == "1"


def _use_bvh(scene: DeviceScene) -> bool:
    """The BVH walk (intersect.py:39-42): a scene with a BVH past
    MAX_SMEM_TRIS triangles; the dispatch tries it after the instances and
    the cluster table."""
    return scene.has_bvh and scene.num_triangles > MAX_SMEM_TRIS


def _flat_call(fn, rays: Rays):
    """Run a flat-[N] query over rays of any batch shape."""
    batch_shape = tuple(rays.batch_shape)
    n = 1
    for s in batch_shape:
        n *= s
    out = fn(rays.reshape(n))
    if isinstance(out, Hits):
        return Hits(**{f: getattr(out, f).reshape(
            batch_shape + getattr(out, f).shape[1:])
            for f in ("t", "prim_id", "inst_id", "mat_id", "uv", "normal")})
    return out.reshape(batch_shape)


def _motion_hits(scene: DeviceScene, rays: Rays, times) -> Hits:
    """The moving triangles' closest hits at `times` (None: 0), material
    ids from the scene's motion table (intersect.py:58-76)."""
    if times is None:
        times = torch.zeros_like(rays.tmin)
    mh = _flat_call(lambda r: motion_mod.intersect_motion_triangles(
        scene.motion_geom, r, times.reshape(-1)), rays)
    mat = scene.motion_tri_mat[torch.clamp_min(mh.prim_id, 0).long()]
    return dataclasses.replace(
        mh, mat_id=torch.where(mh.valid, mat, -1).to(torch.int32))


def scene_closest(scene: DeviceScene, rays: Rays,
                  chunk_size: Optional[int] = None, exact: bool = False,
                  group_walk: bool = False, times=None) -> Hits:
    """exact=True (already-sorted scattered wavefronts) takes the exact
    cull, or the queue under ORT_QWALK=1 (the reference's `exact or not
    coherent`); group_walk gates the walk per 32-ray group on the exact
    cull's bits. Brute force and the BVH walk ignore both; an instance's
    cluster table takes exact, never the queue or the gate.
    times: the rays' shutter times for the moving triangles (None: 0)."""
    if scene.has_instances:
        hits = _flat_call(lambda r: tlas.intersect_instances(
            scene.geom, scene.instances, r, tri_mat=scene.tri_mat,
            chunk_size=chunk_size, boxes=scene.bf_boxes,
            mesh_clusters=scene.instance_clusters, exact=exact), rays)
    elif scene.has_clusters:
        if exact and _use_qwalk():
            hits = _flat_call(lambda r: qwalk_mod.closest_hit(
                scene.clusters, r), rays)
        else:
            hits = _flat_call(lambda r: cluster_mod.closest_hit(
                scene.clusters, r, exact=exact, group_walk=group_walk), rays)
    elif _use_bvh(scene):
        hits = _flat_call(lambda r: trav.traverse(
            scene.bvh, scene.geom, scene.tri_mat, r), rays)
    else:
        hits = bf.intersect_closest(scene.geom, rays, tri_mat=scene.tri_mat,
                                    chunk_size=chunk_size,
                                    boxes=scene.bf_boxes[0])
    if scene.prims.num:
        ph = _flat_call(lambda r: prim_mod.intersect_prims_closest(
            scene.prims, r), rays)
        hits = prim_mod.merge_hits(hits, ph, prim_offset=scene.num_triangles)
    if scene.has_motion:
        hits = prim_mod.merge_hits(
            hits, _motion_hits(scene, rays, times),
            prim_offset=scene.num_triangles + scene.prims.num)
    return hits


def scene_any(scene: DeviceScene, rays: Rays,
              chunk_size: Optional[int] = None, group_walk: bool = False,
              times=None):
    """Occlusion. NEE shadow wavefronts are mixed-liveness even when
    tile-coherent, so the cluster path always takes the exact cull, or the
    queue under ORT_QWALK=1. A scene with cutouts takes the alpha paths
    first (intersect.py:136-146). times: scene_closest's."""
    if scene.has_cutouts:
        if scene.has_omm:
            return _scene_any_alpha_omm(scene, rays, chunk_size,
                                        group_walk=group_walk, times=times)
        return _scene_any_alpha(scene, rays, chunk_size)
    if scene.has_instances:
        occ = _flat_call(lambda r: tlas.intersect_instances_any(
            scene.geom, scene.instances, r, chunk_size=chunk_size,
            boxes=scene.bf_boxes, mesh_clusters=scene.instance_clusters),
            rays)
    elif scene.has_clusters:
        if _use_qwalk():
            occ = _flat_call(lambda r: qwalk_mod.any_hit(scene.clusters, r),
                             rays)
        else:
            occ = _flat_call(lambda r: cluster_mod.any_hit(
                scene.clusters, r, exact=True, group_walk=group_walk), rays)
    elif _use_bvh(scene):
        occ = _flat_call(lambda r: trav.traverse(
            scene.bvh, scene.geom, None, r, any_hit=True), rays)
    else:
        occ = bf.intersect_any(scene.geom, rays, chunk_size=chunk_size,
                               boxes=scene.bf_boxes[0])
    if scene.prims.num:
        occ = occ | _flat_call(lambda r: prim_mod.intersect_prims_any(
            scene.prims, r), rays)
    if scene.has_motion:
        occ = occ | _motion_hits(scene, rays, times).valid
    return occ


def mask_hole(m, uv, tex_alpha=None):
    """The cutout mask style of gathered material rows m (CUT_FIELDS) at
    texture coordinates uv [..., 2] → bool [...], before the alpha mode
    (intersect.py:211-231, engine.py:424-439): the checker, a hole where
    floor(s u) + floor(s v) is even (s = checker_scale); the circle, within
    0.25 of a cell's centre; the texture, where tex_alpha [...] is under
    alpha_cutoff (no hole without tex_alpha)."""
    fu = uv * m["checker_scale"][..., None]
    cell = fu - torch.floor(fu) - 0.5
    checker_hole = torch.remainder(torch.floor(fu[..., 0])
                                   + torch.floor(fu[..., 1]), 2.0) < 1.0
    c0, c1 = cell[..., 0], cell[..., 1]
    circle_hole = (c0 * c0 + c1 * c1) < 0.25 ** 2
    cut = m["cutout"]
    tex_hole = cut == mats.CUT_TEXTURE
    tex_hole = (tex_hole & (tex_alpha < m["alpha_cutoff"])
                if tex_alpha is not None else torch.zeros_like(tex_hole))
    return torch.where(cut == mats.CUT_CHECKER, checker_hole,
                       torch.where(cut == mats.CUT_CIRCLE, circle_hole,
                                   tex_hole))


def certain_or(state, hole):
    """A micromap state [...] overriding a mask's hole [...]: TRANSPARENT
    is a hole, OPAQUE is none, an UNKNOWN state keeps the mask's."""
    return torch.where(state == TRANSPARENT, True,
                       torch.where(state == OPAQUE, False, hole))


def _eval_hole(scene: DeviceScene, m, uv, tex_ok=True):
    """The any-hit side's hole test (intersect.py:203-231): mask_hole with
    the base map's alpha read from the atlas (sample_bilinear, level 0) on
    a textured scene, for ALPHA_MASK materials. tex_ok (bool or a [...]
    mask) switches the texture mask off where the uv is not a texture
    coordinate."""
    tex_alpha = None
    if scene.has_textures and tex_ok is not False:
        tid = m["base_tex"]
        if tex_ok is not True:
            tid = torch.where(tex_ok, tid, -1)
        tex_alpha = sample_bilinear(scene.textures, scene.tex_size, tid,
                                    uv)[..., 3]
    return (m["alpha_mode"] == mats.ALPHA_MASK) & mask_hole(m, uv, tex_alpha)


def cutout_hole_mask(scene: DeviceScene, hits: Hits):
    """True where a hit lands in a hole (intersect.py:234-246): the mask at
    the interpolated texture coordinate of a triangle hit (the shading
    frame's uv, never the barycentrics), at a prim hit's own uv without the
    texture mask."""
    m = mats.gather(scene.materials, hits.mat_id, mats.CUT_FIELDS)
    is_tri = hits.prim_id < scene.num_triangles
    frame = shading_frame(scene.geom, torch.clamp(
        hits.prim_id, 0, scene.num_triangles - 1), hits.uv)
    uv = torch.where(is_tri[..., None], frame["uv"], hits.uv)
    return hits.valid & _eval_hole(scene, m, uv, tex_ok=is_tri)


def _alpha_loop(rays: Rays, done, step):
    """The re-entry loop shared by both alpha paths (intersect.py:318-337,
    352-372): while a ray is unresolved and fewer than MAX_ALPHA_STEPS
    steps have run, step(rays) → (hits, hole); a hit outside a hole
    occludes and resolves its ray, a miss resolves it, a hole moves its
    tmin to ALPHA_STEP past the hit. Resolved rays reach the queries with
    an empty window (tmax 0), which changes no result. → occluded | the
    rays still unresolved."""
    occluded = torch.zeros_like(done)
    tmin = rays.tmin
    ALPHA_STATS["loops"] += 1
    for _ in range(MAX_ALPHA_STEPS):
        if not bool((~done).any()):
            break
        ALPHA_STATS["steps"] += 1
        hits, hole = step(Rays(origin=rays.origin, direction=rays.direction,
                               tmin=tmin,
                               tmax=torch.where(done, 0.0, rays.tmax)))
        solid = hits.valid & ~hole
        occluded = occluded | (solid & ~done)
        done = done | solid | ~hits.valid
        tmin = torch.where(done, tmin, hits.t + ALPHA_STEP)
    return occluded | ~done


def _scene_any_alpha(scene: DeviceScene, rays: Rays, chunk_size=65536):
    """Occlusion past the holes without micromaps (intersect.py:340-377):
    the scene's closest hit, then its mask, a step at a time."""
    def step(cur):
        hits = scene_closest(scene, cur, chunk_size=chunk_size)
        return hits, cutout_hole_mask(scene, hits)

    return _flat_call(lambda r: _alpha_loop(
        r, torch.zeros_like(r.tmin, dtype=torch.bool), step), rays)


def _scene_any_alpha_omm(scene: DeviceScene, rays: Rays, chunk_size=65536,
                         group_walk: bool = False, times=None):
    """Occlusion with the opacity micromaps (intersect.py:249-337): one
    any-hit query over the certain-solid split (its cluster table's exact
    cull and walk, kernels 4 + 6, on any device; else brute force, kernel
    2), the custom prims and the moving triangles (at `times`) folded in;
    then, for the rays it leaves open, the
    re-entry loop over the unknown split alone (kernel 1), where a hit's
    micro-triangle state (micro_index of its barycentrics) decides:
    TRANSPARENT passes, OPAQUE blocks, UNKNOWN evaluates the mask at the
    shading frame's uv. Summary-transparent triangles are in no query. The
    reference's one-hot contractions of the per-hit rows are TPU gather
    devices: here they are index gathers, with the same integer results."""
    solid_cs = scene.omm_solid_clusters
    solid_boxes, unknown_boxes = scene.omm_boxes
    if solid_cs is not None:
        occ0 = _flat_call(lambda r: cluster_mod.any_hit(
            solid_cs, r, exact=True, group_walk=group_walk), rays)
    elif scene.omm_solid_geom.num_triangles:
        occ0 = bf.intersect_any(scene.omm_solid_geom, rays,
                                chunk_size=chunk_size, boxes=solid_boxes)
    else:
        occ0 = torch.zeros_like(rays.tmin, dtype=torch.bool)
    if scene.prims.num:
        occ0 = occ0 | _flat_call(lambda r: prim_mod.intersect_prims_any(
            scene.prims, r), rays)
    if scene.has_motion:
        occ0 = occ0 | _motion_hits(scene, rays, times).valid
    geom = scene.omm_unknown_geom
    if not geom.num_triangles:
        return occ0
    ids = scene.omm_unknown_ids.long()
    micro = scene.omm_micro[ids]                         # [T, 4^level]
    mat_unknown = scene.tri_mat[ids]

    def step(cur):
        hits = bf.intersect_closest(geom, cur, chunk_size=chunk_size,
                                    boxes=unknown_boxes)
        pid = torch.clamp_min(hits.prim_id, 0).long()
        mid = micro_index(hits.uv[..., 0], hits.uv[..., 1], scene.omm_level)
        st = micro[pid, mid]
        m = mats.gather(scene.materials, mat_unknown[pid], mats.CUT_FIELDS)
        uv = shading_frame(geom, pid, hits.uv)["uv"]
        return hits, certain_or(st, _eval_hole(scene, m, uv))

    return occ0 | _flat_call(lambda r: _alpha_loop(r, occ0.reshape(-1), step),
                             rays)
