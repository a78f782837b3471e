"""Scene-level intersection (counterpart of `wavefront/intersect.py:78-200`):
the instance loop for a two-level scene (`accel/tlas.py`), the
cluster-culled traversal for a scene with a cluster table, brute force
otherwise (culled by the scene's group boxes, `DeviceScene.bf_boxes`),
then the custom prims merged in (`accel/primitives.py`; a prim
hit reports prim_id = num_triangles + its row). BVHs, motion and cutout
any-hit are not ported yet (ROADMAP.md Queue 1 items 6-9); the port's
DeviceScene has none of them.

In the JAX package the cluster branch runs only on a TPU; in the port a
cluster table alone selects it, on any device (the CPU runs the kernels'
plain versions). With ORT_QWALK=1 the cluster branch sends exact-cull
closest-hit queries and every any-hit query through the cluster-major queue
(`accel/qwalk.py`), as the reference does.
"""
from __future__ import annotations

import os
from typing import Optional

from ..accel import bruteforce as bf
from ..accel import clusters as cluster_mod
from ..accel import primitives as prim_mod
from ..accel import qwalk as qwalk_mod
from ..accel import tlas
from ..core.rays import Hits, Rays
from ..scene.device_scene import DeviceScene


def _use_qwalk() -> bool:
    """The opt-in queue traversal (intersect.py:30-36): ORT_QWALK=1, read at
    call time."""
    return os.environ.get("ORT_QWALK", "0") == "1"


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


def scene_closest(scene: DeviceScene, rays: Rays,
                  chunk_size: Optional[int] = None, exact: bool = False,
                  group_walk: bool = False) -> Hits:
    """exact=True (already-sorted scattered wavefronts) takes the exact
    cull, or the queue under ORT_QWALK=1 (the reference's `exact or not
    coherent`); group_walk gates the walk per 32-ray group on the exact
    cull's bits. Both are ignored by brute force and by the instances."""
    if scene.has_instances:
        hits = _flat_call(lambda r: tlas.intersect_instances(
            scene.geom, scene.instances, r, tri_mat=scene.tri_mat,
            chunk_size=chunk_size, boxes=scene.bf_boxes), rays)
    elif scene.has_clusters:
        if exact and _use_qwalk():
            hits = _flat_call(lambda r: qwalk_mod.closest_hit(
                scene.clusters, r), rays)
        else:
            hits = _flat_call(lambda r: cluster_mod.closest_hit(
                scene.clusters, r, exact=exact, group_walk=group_walk), rays)
    else:
        hits = bf.intersect_closest(scene.geom, rays, tri_mat=scene.tri_mat,
                                    chunk_size=chunk_size,
                                    boxes=scene.bf_boxes[0])
    if scene.prims.num:
        ph = _flat_call(lambda r: prim_mod.intersect_prims_closest(
            scene.prims, r), rays)
        hits = prim_mod.merge_hits(hits, ph, prim_offset=scene.num_triangles)
    return hits


def scene_any(scene: DeviceScene, rays: Rays,
              chunk_size: Optional[int] = None, group_walk: bool = False):
    """Occlusion. NEE shadow wavefronts are mixed-liveness even when
    tile-coherent, so the cluster path always takes the exact cull, or the
    queue under ORT_QWALK=1."""
    if scene.has_instances:
        occ = _flat_call(lambda r: tlas.intersect_instances_any(
            scene.geom, scene.instances, r, chunk_size=chunk_size,
            boxes=scene.bf_boxes), rays)
    elif scene.has_clusters:
        if _use_qwalk():
            occ = _flat_call(lambda r: qwalk_mod.any_hit(scene.clusters, r),
                             rays)
        else:
            occ = _flat_call(lambda r: cluster_mod.any_hit(
                scene.clusters, r, exact=True, group_walk=group_walk), rays)
    else:
        occ = bf.intersect_any(scene.geom, rays, chunk_size=chunk_size,
                               boxes=scene.bf_boxes[0])
    if scene.prims.num:
        occ = occ | _flat_call(lambda r: prim_mod.intersect_prims_any(
            scene.prims, r), rays)
    return occ
