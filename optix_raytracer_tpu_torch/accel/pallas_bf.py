"""Brute-force closest-hit / any-hit: kernels 1 and 2 and their plain versions
(counterpart of `accel/pallas_bf.py`; the kernels are `csrc/bf.cu`).

`closest_hit` / `any_hit` take the triangle constants and a flat [N] ray
batch. On CUDA tensors they launch the kernel; on CPU tensors they run the
plain PyTorch version, which tests the rays against all triangles at once in
`_tri_test`'s order of operations and so rounds exactly as the kernel does.

With `boxes` (`tri_groups.bf_group_boxes`: the widened boxes of groups of
FUSED_GROUP consecutive triangles) the kernels cull the table by groups, as
the fused kernel does; the values stay brute force's bit for bit. The culled
loops in torch (`_group_walk`, `closest_hit_groups_plain`,
`any_hit_groups_plain`) hold that rule on the CPU and count the tests.
"""
from __future__ import annotations

import torch

from .. import kernels
from ..core.rays import Rays
from .tri_groups import BOX_COLS, FUSED_GROUP, fused_group_admitted_plain

_DEGEN_EPS = 1e-12


def _woop(col, ox, oy, oz, dx, dy, dz):
    """The Woop test on broadcastable tri_consts columns col[0:12] → (tt,
    uu, vv, dpz), in csrc/common.cuh tri_test's order of operations."""
    (w00, w01, w02, w10, w11, w12, w20, w21, w22, c0, c1, c2) = col
    opx = ox * w00 + oy * w01 + oz * w02 + c0
    opy = ox * w10 + oy * w11 + oz * w12 + c1
    opz = ox * w20 + oy * w21 + oz * w22 + c2
    dpx = dx * w00 + dy * w01 + dz * w02
    dpy = dx * w10 + dy * w11 + dz * w12
    dpz = dx * w20 + dy * w21 + dz * w22
    inv = 1.0 / dpz
    tt = -opz * inv
    uu = opx + tt * dpx
    vv = opy + tt * dpy
    return tt, uu, vv, dpz


def _tri_test(c, ox, oy, oz, dx, dy, dz):
    """Unit-triangle hit candidates: c is [M, 16] (broadcast as [1, M]), the
    ray components [n, 1] → (tt, uu, vv, dpz), each [n, M]."""
    return _woop([c[None, :, j] for j in range(12)], ox, oy, oz, dx, dy, dz)


def _accept(tt, uu, vv, dpz, tmin, tmax):
    return ((torch.abs(dpz) > _DEGEN_EPS)
            & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
            & (tt > tmin) & (tt < tmax))


def _chunks(n, chunk_size):
    step = n if not chunk_size else chunk_size
    return [(s, min(s + step, n)) for s in range(0, n, max(step, 1))]


def _ray_cols(rays: Rays, s, e):
    o, d = rays.origin[s:e], rays.direction[s:e]
    return ([o[:, k:k + 1] for k in range(3)] + [d[:, k:k + 1] for k in range(3)]
            + [rays.tmin[s:e, None], rays.tmax[s:e, None]])


def closest_hit_plain(tri_consts, tri_mat, rays: Rays, chunk_size=65536):
    """Plain version of kernel 1. The first triangle reaching the minimum t
    wins, as in the running minimum with a strict `<`."""
    n = rays.tmin.shape[0]
    dev = tri_consts.device
    t = rays.tmax.clone()
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    mat = torch.full((n,), -1, dtype=torch.int32, device=dev)
    uv = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    normal = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    for s, e in _chunks(n, chunk_size):
        ox, oy, oz, dx, dy, dz, tmin, tmax = _ray_cols(rays, s, e)
        tt, uu, vv, dpz = _tri_test(tri_consts, ox, oy, oz, dx, dy, dz)
        ok = _accept(tt, uu, vv, dpz, tmin, tmax)
        best = torch.argmin(torch.where(ok, tt, torch.inf), dim=1)
        hit = ok.gather(1, best[:, None])[:, 0]
        rows = best[:, None]
        t[s:e] = torch.where(hit, tt.gather(1, rows)[:, 0], t[s:e])
        prim[s:e] = torch.where(hit, best.to(torch.int32), -1)
        mat[s:e] = torch.where(hit, tri_mat[best].to(torch.int32), -1)
        uv[s:e] = torch.where(hit[:, None], torch.cat(
            [uu.gather(1, rows), vv.gather(1, rows)], dim=1), 0.0)
        normal[s:e] = torch.where(hit[:, None], tri_consts[best, 12:15], 0.0)
    return dict(t=t, prim_id=prim, mat_id=mat, uv=uv, normal=normal)


def any_hit_plain(tri_consts, rays: Rays, chunk_size=65536):
    """Plain version of kernel 2: any triangle with tmin < t < tmax."""
    n = rays.tmin.shape[0]
    occ = torch.zeros((n,), dtype=torch.bool, device=tri_consts.device)
    for s, e in _chunks(n, chunk_size):
        ox, oy, oz, dx, dy, dz, tmin, tmax = _ray_cols(rays, s, e)
        tt, uu, vv, dpz = _tri_test(tri_consts, ox, oy, oz, dx, dy, dz)
        occ[s:e] = _accept(tt, uu, vv, dpz, tmin, tmax).any(dim=1)
    return occ


def _group_walk(tri, boxes, group, o, d, tmin, tmax, any_hit):
    """The culled triangle loop of kernels 1-3 over rays o, d [N, 3], tmin,
    tmax [N]: groups ascending, a group's triangles ascending, the strict t
    < best t → (best t [N] or None with any_hit, id [N] int64 (-1 none) or
    occluded [N] with any_hit, tests [N] int64: the ray-triangle tests the
    loop makes, the triangles of each admitted group up to the first
    occluder with any_hit, slabs [N] int64: the group slab tests it makes
    (none without culling), admitted [N, groups] bool: the groups the ray
    tests). With group >= M or no boxes the table is one group, tested
    whole."""
    m = tri.shape[0]
    n = o.shape[0]
    if boxes is None:
        group = max(m, 1)
    cols = [o[:, k:k + 1] for k in range(3)] + [d[:, k:k + 1]
                                                 for k in range(3)]
    bt = tmax.clone()
    bid = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    tests = torch.zeros((n,), dtype=torch.int64, device=o.device)
    slabs = torch.zeros((n,), dtype=torch.int64, device=o.device)
    done = torch.zeros((n,), dtype=torch.bool, device=o.device)
    admitted = torch.zeros((n, -(-m // group)), dtype=torch.bool,
                           device=o.device)
    for g, t0 in enumerate(range(0, m, group)):
        t1 = min(t0 + group, m)
        adm = (tmax > tmin) & ~done
        if group < m:
            slabs += adm.to(torch.int64)
            adm = adm & fused_group_admitted_plain(o, d, tmin, bt,
                                                   boxes[g:g + 1])[:, 0]
        admitted[:, g] = adm
        tt, uu, vv, dpz = _tri_test(tri[t0:t1], *cols)
        acc = (_accept(tt, uu, vv, dpz, tmin[:, None], bt[:, None])
               & adm[:, None])
        if any_hit:
            first = torch.where(acc.any(dim=1), acc.int().argmax(dim=1),
                                t1 - t0 - 1)
            tests += torch.where(adm, first + 1, 0)
            done = done | acc.any(dim=1)
            continue
        tests += adm.to(torch.int64) * (t1 - t0)
        for j in range(t1 - t0):      # ascending, strict: the lowest wins
            win = acc[:, j] & (tt[:, j] < bt)
            bt = torch.where(win, tt[:, j], bt)
            bid = torch.where(win, t0 + j, bid)
    if any_hit:
        return None, done, tests, slabs, admitted
    return bt, bid, tests, slabs, admitted


def closest_hit_groups_plain(tri_consts, tri_mat, rays: Rays, boxes):
    """Kernel 1's culled loop in torch at closest_hit's interface (boxes
    tri_groups.bf_group_boxes(geom), or None: the table whole) → its dict;
    the winner's uv from the Woop test re-run on its row (the loop's
    arithmetic, so the loop's bits). Equal to closest_hit_plain bit for
    bit."""
    o, d = rays.origin, rays.direction
    bt, bid, _, _, _ = _group_walk(tri_consts, boxes, FUSED_GROUP, o, d,
                                   rays.tmin, rays.tmax, False)
    hit = bid >= 0
    row = tri_consts[bid.clamp_min(0)]
    tt, uu, vv, _ = _woop([row[:, j] for j in range(12)],
                          *[o[:, k] for k in range(3)],
                          *[d[:, k] for k in range(3)])
    return dict(t=bt, prim_id=torch.where(hit, bid, -1).to(torch.int32),
                mat_id=torch.where(hit, tri_mat[bid.clamp_min(0)].to(
                    torch.int32), -1),
                uv=torch.where(hit[:, None], torch.stack([uu, vv], dim=1),
                               0.0),
                normal=torch.where(hit[:, None], row[:, 12:15], 0.0))


def any_hit_groups_plain(tri_consts, rays: Rays, boxes):
    """Kernel 2's culled loop in torch → occluded [N] bool, equal to
    any_hit_plain."""
    return _group_walk(tri_consts, boxes, FUSED_GROUP, rays.origin,
                       rays.direction, rays.tmin, rays.tmax, True)[1]


def _ray_planes(tri_consts, rays: Rays, boxes):
    """Validated contiguous ray planes for the kernels, the group boxes and
    the group size they cull by: FUSED_GROUP with boxes (bf_group_boxes),
    M without (the table whole)."""
    dev = tri_consts.device
    n = rays.tmin.shape[0]
    m = tri_consts.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"{n} rays: the kernels index rays with int32")
    kernels.require(tri_consts, "tri_consts", torch.float32, (m, 16), dev)
    planes = (rays.origin.contiguous(), rays.direction.contiguous(),
              rays.tmin.contiguous(), rays.tmax.contiguous())
    for name, p, shape in zip(("origin", "direction", "tmin", "tmax"), planes,
                              ((n, 3), (n, 3), (n,), (n,))):
        kernels.require(p, name, torch.float32, shape, dev)
    group = FUSED_GROUP
    if boxes is None or group >= m:
        boxes, group = None, max(m, 1)
    else:
        kernels.require(boxes, "boxes", torch.float32,
                        (-(-m // group), BOX_COLS), dev)
    # the rows are read as float4: 16-byte aligned
    for name, t in (("tri_consts", tri_consts), ("boxes", boxes)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: not 16-byte aligned")
    return planes, boxes, group


def closest_hit(tri_consts, tri_mat, rays: Rays, chunk_size=65536,
                boxes=None):
    """Closest hit of a flat [N] ray batch → dict(t, prim_id, mat_id, uv,
    normal); a miss has prim_id = mat_id = -1, t = tmax, uv = normal = 0.
    boxes: the table's group boxes (tri_groups.bf_group_boxes) for the
    kernel to cull by, or None; the values are the same either way (on the
    CPU brute force's plain version runs)."""
    dev = tri_consts.device
    if dev.type == "cpu":
        return closest_hit_plain(tri_consts, tri_mat, rays, chunk_size)
    if dev.type != "cuda":
        raise ValueError(f"closest_hit: unsupported device {dev}")
    (org, dirs, tmin, tmax), boxes, group = _ray_planes(tri_consts, rays,
                                                        boxes)
    n, m = tmin.shape[0], tri_consts.shape[0]
    kernels.require(tri_mat, "tri_mat", torch.int32, (m,), dev)
    out = dict(t=torch.empty((n,), dtype=torch.float32, device=dev),
               prim_id=torch.empty((n,), dtype=torch.int32, device=dev),
               mat_id=torch.empty((n,), dtype=torch.int32, device=dev),
               uv=torch.empty((n, 2), dtype=torch.float32, device=dev),
               normal=torch.empty((n, 3), dtype=torch.float32, device=dev))
    if n == 0:
        return out
    with torch.cuda.device(dev), kernels.launch("bf_closest"):
        err = kernels.lib().ort_bf_closest(
            tri_consts.data_ptr(), tri_mat.data_ptr(), m,
            0 if boxes is None else boxes.data_ptr(), group, org.data_ptr(),
            dirs.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), n,
            out["t"].data_ptr(), out["prim_id"].data_ptr(),
            out["mat_id"].data_ptr(), out["uv"].data_ptr(),
            out["normal"].data_ptr(), kernels.stream_ptr(dev))
    kernels.check(err, "bf_closest")
    return out


def any_hit(tri_consts, rays: Rays, chunk_size=65536, boxes=None):
    """Occlusion of a flat [N] ray batch → bool [N]; boxes as closest_hit."""
    dev = tri_consts.device
    if dev.type == "cpu":
        return any_hit_plain(tri_consts, rays, chunk_size)
    if dev.type != "cuda":
        raise ValueError(f"any_hit: unsupported device {dev}")
    (org, dirs, tmin, tmax), boxes, group = _ray_planes(tri_consts, rays,
                                                        boxes)
    n, m = tmin.shape[0], tri_consts.shape[0]
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return occ
    with torch.cuda.device(dev), kernels.launch("bf_any"):
        err = kernels.lib().ort_bf_any(
            tri_consts.data_ptr(), m, 0 if boxes is None else boxes.data_ptr(),
            group, org.data_ptr(), dirs.data_ptr(), tmin.data_ptr(),
            tmax.data_ptr(), n, occ.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(err, "bf_any")
    return occ
