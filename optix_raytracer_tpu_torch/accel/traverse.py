"""Stackless threaded-BVH traversal (counterpart of `accel/traverse.py`):
one node index of state per ray.

At node ptr a ray tests the node's box against [tmin, best t]; on a hit of
an internal node it descends (ptr + 1), otherwise it takes the node's
escape index, and at a leaf whose box it hits it runs the unit-triangle
test of the leaf's triangle, whose strict t < best t shrinks the window and
prunes the later subtrees. The walk ends past the last node (or at the first
occluder for any-hit).

`traverse` takes the LBVH, the geometry and a flat [N] ray batch. On CUDA
tensors it launches `csrc/bvh.cu::bvh_walk_kernel<kClosest>`, one thread a
ray, the whole wavefront in one launch; a failed build or launch raises. On
CPU tensors it runs `traverse_plain`, the reference's lock-step loop
(traverse.py:51-133): every live ray steps one node a step until the
slowest is done. Both compute the same sums in the same order (the 3x3
products written out, no einsum; t a true division -op_z / safe, the
reference's, not a reciprocal; the clamped slab reciprocal 1 / d_safe), so
the kernel equals the plain loop bit for bit. Each ray's walk depends on its
own state alone, so the lock-step order and the kernel's per-ray loop
visit the same nodes.
"""
from __future__ import annotations

import torch

from .. import kernels
from ..core.rays import Hits, Rays
from .geometry import TriangleGeometry
from .lbvh import LBVH

_DEGEN_EPS = 1e-12
# The plain loop tests whether every ray is done (a host sync) once per this
# many steps; steps past a ray's end change nothing of it.
_SYNC_EVERY = 16


def _woop_test(tri_consts, prim, o, d):
    """The unit-triangle test of triangle prim [N] per ray (traverse.py:
    30-48) → (t, u, v, ok), in csrc/bvh.cu's order of operations."""
    c = tri_consts[prim]                                    # [N, 16]
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    opx = ((c[:, 0] * ox + c[:, 1] * oy) + c[:, 2] * oz) + c[:, 9]
    opy = ((c[:, 3] * ox + c[:, 4] * oy) + c[:, 5] * oz) + c[:, 10]
    opz = ((c[:, 6] * ox + c[:, 7] * oy) + c[:, 8] * oz) + c[:, 11]
    dpx = (c[:, 0] * dx + c[:, 1] * dy) + c[:, 2] * dz
    dpy = (c[:, 3] * dx + c[:, 4] * dy) + c[:, 5] * dz
    dpz = (c[:, 6] * dx + c[:, 7] * dy) + c[:, 8] * dz
    small = torch.abs(dpz) < _DEGEN_EPS
    safe = torch.where(small, _DEGEN_EPS, dpz)
    t = -opz / safe
    u = opx + t * dpx
    v = opy + t * dpy
    ok = ~small & (u >= 0) & (v >= 0) & (u + v <= 1.0)
    return t, u, v, ok


def slab_reciprocal(d):
    """1 / d with |d| clamped to at least 1e-12, the sign kept (-0.0 takes
    +1e-12): an origin component on a box bound then gives a finite 0 *
    inv, never the NaN of 0 * inf (traverse.py:69-75)."""
    d_safe = torch.where(torch.abs(d) < _DEGEN_EPS,
                         torch.where(d < 0, -_DEGEN_EPS, _DEGEN_EPS), d)
    return 1.0 / d_safe


def _box_hit(lo, hi, o, inv_d, tmin, t):
    """The slab test of node boxes lo, hi [N, 3] against [tmin, t]: NaN
    anywhere gives a miss (torch's minimum / maximum pass NaN on)."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    near = torch.minimum(t0, t1)
    far = torch.maximum(t0, t1)
    t_near = torch.maximum(torch.maximum(near[:, 0], near[:, 1]), near[:, 2])
    t_far = torch.minimum(torch.minimum(far[:, 0], far[:, 1]), far[:, 2])
    return torch.maximum(t_near, tmin) <= torch.minimum(t_far, t)


def walk_plain(bvh: LBVH, tri_consts, rays: Rays, any_hit: bool = False,
               counts: bool = False):
    """The reference's lock-step walk (traverse.py:59-120) → (t, prim, u,
    v) [N] of the best hit (prim -1 and t = tmax where none), or occluded
    [N] with any_hit; with counts, also the nodes each ray visited and the
    leaf tests it made (int64 [N] each), and which nodes any ray visited
    and which triangles any ray tested (bool [num_nodes], [M])."""
    n = rays.tmin.shape[0]
    dev = rays.origin.device
    end = bvh.num_nodes
    o, d = rays.origin, rays.direction
    inv_d = slab_reciprocal(d)
    ptr = torch.zeros((n,), dtype=torch.int64, device=dev)
    t = rays.tmax.clone()
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros((n,), dtype=torch.float32, device=dev)
    v = torch.zeros((n,), dtype=torch.float32, device=dev)
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    visits = torch.zeros((n,), dtype=torch.int64, device=dev)
    tests = torch.zeros((n,), dtype=torch.int64, device=dev)
    if counts:     # the last slot of each takes the lanes that touch none
        node_seen = torch.zeros((end + 1,), dtype=torch.bool, device=dev)
        tri_seen = torch.zeros((tri_consts.shape[0] + 1,), dtype=torch.bool,
                               device=dev)
    skip_all = bvh.node_skip.to(torch.int64)
    prim_all = bvh.node_prim
    step = 0
    while True:
        if step % _SYNC_EVERY == 0 and bool(done.all()):
            break
        step += 1
        p = torch.clamp_max(ptr, end - 1)
        live = ~done
        node_prim = prim_all[p]
        box = _box_hit(bvh.node_lo[p], bvh.node_hi[p], o, inv_d, rays.tmin,
                       t)
        leaf = node_prim >= 0
        tt, uu, vv, ok = _woop_test(tri_consts,
                                    torch.clamp_min(node_prim, 0).long(), o,
                                    d)
        hit = live & box & leaf & ok & (tt > rays.tmin) & (tt < t)
        if counts:
            tested = live & box & leaf
            visits += live.to(torch.int64)
            tests += tested.to(torch.int64)
            node_seen[torch.where(live, p, end)] = True
            tri_seen[torch.where(tested, node_prim.long(), -1)] = True
        t = torch.where(hit, tt, t)
        prim = torch.where(hit, node_prim, prim)
        u = torch.where(hit, uu, u)
        v = torch.where(hit, vv, v)
        new_ptr = torch.where(box & ~leaf, p + 1, skip_all[p])
        done = done | (new_ptr >= end)
        if any_hit:
            done = done | hit
        ptr = torch.where(live, new_ptr, ptr)
    out = (prim >= 0,) if any_hit else (t, prim, u, v)
    if counts:
        out += (visits, tests, node_seen[:-1], tri_seen[:-1])
    return out


def _hits(geom: TriangleGeometry, tri_mat, rays: Rays, t, prim, u, v):
    """The walk's best hit as `Hits` (traverse.py:122-133): on a miss t =
    tmax, ids -1, normal 0; uv as the walk left it (0 on a miss)."""
    hit = prim >= 0
    pid = torch.clamp_min(prim, 0).long()
    mat = (tri_mat[pid].to(torch.int32) if tri_mat is not None
           else torch.zeros_like(prim))
    return Hits(t=torch.where(hit, t, rays.tmax),
                prim_id=torch.where(hit, prim, -1).to(torch.int32),
                inst_id=torch.where(hit, 0, -1).to(torch.int32),
                mat_id=torch.where(hit, mat, -1).to(torch.int32),
                uv=torch.stack([u, v], dim=-1),
                normal=torch.where(hit[:, None], geom.face_normal[pid], 0.0))


def traverse_plain(bvh: LBVH, geom: TriangleGeometry, tri_mat, rays: Rays,
                   any_hit: bool = False):
    """The plain version of `traverse`: Hits, or occluded [N] bool."""
    out = walk_plain(bvh, geom.tri_consts, rays, any_hit)
    return out[0] if any_hit else _hits(geom, tri_mat, rays, *out)


def _require_walk(bvh: LBVH, tri_consts, rays: Rays):
    dev = tri_consts.device
    n, m = rays.tmin.shape[0], tri_consts.shape[0]
    if n >= 2 ** 31 or bvh.num_nodes >= 2 ** 31:
        raise ValueError("the walk kernel indexes rays and nodes with int32")
    if bvh.num_nodes != max(2 * m - 1, 0):
        raise ValueError(f"a BVH of {bvh.num_nodes} nodes over {m} "
                         f"triangles")
    nodes = bvh.nodes
    kernels.require(nodes, "nodes", torch.float32, (bvh.num_nodes, 8), dev)
    kernels.require(tri_consts, "tri_consts", torch.float32, (m, 16), dev)
    planes = (rays.origin.contiguous(), rays.direction.contiguous(),
              rays.tmin.contiguous(), rays.tmax.contiguous())
    for name, p, shape in zip(("origin", "direction", "tmin", "tmax"), planes,
                              ((n, 3), (n, 3), (n,), (n,))):
        kernels.require(p, name, torch.float32, shape, dev)
    for name, t in (("nodes", nodes), ("tri_consts", tri_consts)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: not 16-byte aligned")
    return nodes, planes


def walk_closest(bvh: LBVH, tri_consts, tri_mat, rays: Rays) -> dict:
    """Closest hit of a flat [N] CUDA ray batch through
    bvh_walk_kernel<true> → dict(t, prim_id, mat_id, uv, normal) (a miss:
    t = tmax, ids -1, uv and normal 0). tri_mat: [M] int32."""
    dev = tri_consts.device
    nodes, (org, dirs, tmin, tmax) = _require_walk(bvh, tri_consts, rays)
    n, m = tmin.shape[0], tri_consts.shape[0]
    kernels.require(tri_mat, "tri_mat", torch.int32, (m,), dev)
    out = dict(t=torch.empty((n,), dtype=torch.float32, device=dev),
               prim_id=torch.empty((n,), dtype=torch.int32, device=dev),
               mat_id=torch.empty((n,), dtype=torch.int32, device=dev),
               uv=torch.empty((n, 2), dtype=torch.float32, device=dev),
               normal=torch.empty((n, 3), dtype=torch.float32, device=dev))
    if n == 0:
        return out
    with torch.cuda.device(dev), kernels.launch("bvh_walk_closest"):
        err = kernels.lib().ort_bvh_closest(
            nodes.data_ptr(), bvh.num_nodes, tri_consts.data_ptr(),
            tri_mat.data_ptr(), org.data_ptr(), dirs.data_ptr(),
            tmin.data_ptr(), tmax.data_ptr(), n, out["t"].data_ptr(),
            out["prim_id"].data_ptr(), out["mat_id"].data_ptr(),
            out["uv"].data_ptr(), out["normal"].data_ptr(),
            kernels.stream_ptr(dev))
    kernels.check(err, "bvh_walk_closest")
    return out


def walk_any(bvh: LBVH, tri_consts, rays: Rays) -> torch.Tensor:
    """Occlusion of a flat [N] CUDA ray batch through bvh_walk_kernel<false>
    → bool [N]."""
    dev = tri_consts.device
    nodes, (org, dirs, tmin, tmax) = _require_walk(bvh, tri_consts, rays)
    n = tmin.shape[0]
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return occ
    with torch.cuda.device(dev), kernels.launch("bvh_walk_any"):
        err = kernels.lib().ort_bvh_any(
            nodes.data_ptr(), bvh.num_nodes, tri_consts.data_ptr(),
            org.data_ptr(), dirs.data_ptr(), tmin.data_ptr(),
            tmax.data_ptr(), n, occ.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(err, "bvh_walk_any")
    return occ


def traverse(bvh: LBVH, geom: TriangleGeometry, tri_mat, rays: Rays,
             any_hit: bool = False):
    """Closest hit (Hits) or occlusion (bool [N]) of a flat [N] ray batch
    through the threaded BVH (traverse.py:51-133). tri_mat: [M] material
    ids or None (ids 0)."""
    dev = geom.tri_consts.device
    if dev.type == "cpu":
        return traverse_plain(bvh, geom, tri_mat, rays, any_hit)
    if dev.type != "cuda":
        raise ValueError(f"traverse: unsupported device {dev}")
    if any_hit:
        return walk_any(bvh, geom.tri_consts, rays)
    if tri_mat is None:
        tri_mat = torch.zeros((geom.num_triangles,), dtype=torch.int32,
                              device=dev)
    out = walk_closest(bvh, geom.tri_consts, tri_mat.to(torch.int32), rays)
    hit = out["prim_id"] >= 0
    return Hits(t=out["t"], prim_id=out["prim_id"],
                inst_id=torch.where(hit, 0, -1).to(torch.int32),
                mat_id=out["mat_id"], uv=out["uv"], normal=out["normal"])
