"""Scene-level intersection, brute-force branch only (counterpart of
`wavefront/intersect.py:78-200`). Prims, instances, clusters, BVHs, motion
and cutout any-hit are not ported yet (ROADMAP.md Queue 1 items 6-9); the
port's DeviceScene has none of them."""
from __future__ import annotations

from typing import Optional

from ..accel import bruteforce as bf
from ..core.rays import Hits, Rays
from ..scene.device_scene import DeviceScene


def scene_closest(scene: DeviceScene, rays: Rays,
                  chunk_size: Optional[int] = None) -> Hits:
    return bf.intersect_closest(scene.geom, rays, tri_mat=scene.tri_mat,
                                chunk_size=chunk_size)


def scene_any(scene: DeviceScene, rays: Rays,
              chunk_size: Optional[int] = None):
    return bf.intersect_any(scene.geom, rays, chunk_size=chunk_size)
