"""Brute-force closest-hit / any-hit: kernels 1 and 2 and their plain versions
(counterpart of `accel/pallas_bf.py`; the kernels are `csrc/bf.cu`).

`closest_hit` / `any_hit` take the triangle constants and a flat [N] ray
batch. On CUDA tensors they launch the kernel; on CPU tensors they run the
plain PyTorch version, which tests the rays against all triangles at once in
`_tri_test`'s order of operations and so rounds exactly as the kernel does.
"""
from __future__ import annotations

import torch

from .. import kernels
from ..core.rays import Rays

_DEGEN_EPS = 1e-12


def _tri_test(c, ox, oy, oz, dx, dy, dz):
    """Unit-triangle hit candidates: c is [M, 16] (broadcast as [1, M]), the
    ray components [n, 1] → (tt, uu, vv, dpz), each [n, M]."""
    col = [c[None, :, j] for j in range(12)]
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


def _ray_planes(tri_consts, rays: Rays):
    """Validated contiguous ray planes for the kernels."""
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
    return planes


def closest_hit(tri_consts, tri_mat, rays: Rays, chunk_size=65536):
    """Closest hit of a flat [N] ray batch → dict(t, prim_id, mat_id, uv,
    normal); a miss has prim_id = mat_id = -1, t = tmax, uv = normal = 0."""
    dev = tri_consts.device
    if dev.type == "cpu":
        return closest_hit_plain(tri_consts, tri_mat, rays, chunk_size)
    if dev.type != "cuda":
        raise ValueError(f"closest_hit: unsupported device {dev}")
    org, dirs, tmin, tmax = _ray_planes(tri_consts, rays)
    n, m = tmin.shape[0], tri_consts.shape[0]
    kernels.require(tri_mat, "tri_mat", torch.int32, (m,), dev)
    out = dict(t=torch.empty((n,), dtype=torch.float32, device=dev),
               prim_id=torch.empty((n,), dtype=torch.int32, device=dev),
               mat_id=torch.empty((n,), dtype=torch.int32, device=dev),
               uv=torch.empty((n, 2), dtype=torch.float32, device=dev),
               normal=torch.empty((n, 3), dtype=torch.float32, device=dev))
    if n == 0:
        return out
    with torch.cuda.device(dev):
        err = kernels.lib().ort_bf_closest(
            tri_consts.data_ptr(), tri_mat.data_ptr(), m, org.data_ptr(),
            dirs.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), n,
            out["t"].data_ptr(), out["prim_id"].data_ptr(),
            out["mat_id"].data_ptr(), out["uv"].data_ptr(),
            out["normal"].data_ptr(), kernels.stream_ptr(dev))
        kernels.LAUNCHES["bf_closest"] += 1
    kernels.check(err, "bf_closest")
    return out


def any_hit(tri_consts, rays: Rays, chunk_size=65536):
    """Occlusion of a flat [N] ray batch → bool [N]."""
    dev = tri_consts.device
    if dev.type == "cpu":
        return any_hit_plain(tri_consts, rays, chunk_size)
    if dev.type != "cuda":
        raise ValueError(f"any_hit: unsupported device {dev}")
    org, dirs, tmin, tmax = _ray_planes(tri_consts, rays)
    n, m = tmin.shape[0], tri_consts.shape[0]
    occ = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return occ != 0
    with torch.cuda.device(dev):
        err = kernels.lib().ort_bf_any(
            tri_consts.data_ptr(), m, org.data_ptr(), dirs.data_ptr(),
            tmin.data_ptr(), tmax.data_ptr(), n, occ.data_ptr(),
            kernels.stream_ptr(dev))
        kernels.LAUNCHES["bf_any"] += 1
    kernels.check(err, "bf_any")
    return occ != 0
