"""Motion blur (counterpart of `accel/motion.py`): triangles with two vertex
keys and moving spheres, intersected at a time per ray, and SRT motion
transforms that carry rays into an instance's object space at their time.

The moving triangles are lerped per ray and tested by Möller–Trumbore over
[N, M] planes (the Woop constants of kernels 1-2 cannot be shared across
times), in torch ops on any device. The rays are taken in chunks so that
no [chunk, M] plane holds more than `primitives.PLANE_ELEMS` elements
(`primitives.chunk_bounds`); each ray's answer does not depend on its
chunk. An SRT-keyed instance needs no plane of its own: its rays go to
object space (`rays_to_object_space`), the static geometry answers them
(kernel 1 on CUDA, `bruteforce.intersect_closest`), and
`hits_to_world_space` brings the normals back.

`_slerp` follows the reference's rule (motion.py:158-168), which sums the
quaternion products over every ray of the batch: for more than one ray the
clip makes theta 0, and the weights become a lerp's (a normalised lerp of
the keys); for one ray it is the true slerp. Its arccos and sin may round
apart from XLA's in the last ulp; the tests hold its outputs within 1e-5.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.rays import Hits, Rays
from ..core.vecmath import cross, dot, normalize
from . import primitives as prim_mod

_EPS = 1e-12


@dataclasses.dataclass
class MotionTriangles:
    """A triangle mesh with two vertex keys (time 0 and time 1): per key the
    first vertex and the two edges, [M, 3] each."""
    v0_0: torch.Tensor
    e1_0: torch.Tensor
    e2_0: torch.Tensor
    v0_1: torch.Tensor
    e1_1: torch.Tensor
    e2_1: torch.Tensor

    @classmethod
    def make(cls, verts0, verts1, indices, device):
        verts0 = torch.as_tensor(verts0, dtype=torch.float32, device=device)
        verts1 = torch.as_tensor(verts1, dtype=torch.float32, device=device)
        indices = torch.as_tensor(indices, device=device).long()

        def tables(v):
            v0 = v[indices[:, 0]]
            return v0, v[indices[:, 1]] - v0, v[indices[:, 2]] - v0

        a, b = tables(verts0), tables(verts1)
        return cls(v0_0=a[0], e1_0=a[1], e2_0=a[2],
                   v0_1=b[0], e1_1=b[1], e2_1=b[2])

    @classmethod
    def empty(cls, device):
        z = torch.zeros((0, 3), dtype=torch.float32, device=device)
        return cls(v0_0=z, e1_0=z, e2_0=z, v0_1=z, e1_1=z, e2_1=z)

    @property
    def num_triangles(self):
        return self.v0_0.shape[0]


def _motion_tri_chunk(geom: MotionTriangles, rays: Rays, times):
    t_lerp = times[:, None, None]
    v0 = geom.v0_0[None] + t_lerp * (geom.v0_1 - geom.v0_0)[None]
    e1 = geom.e1_0[None] + t_lerp * (geom.e1_1 - geom.e1_0)[None]
    e2 = geom.e2_0[None] + t_lerp * (geom.e2_1 - geom.e2_0)[None]
    o = rays.origin[:, None, :]
    d = rays.direction[:, None, :]
    pvec = cross(d.expand_as(e2), e2)
    det = dot(e1, pvec)
    inv_det = torch.where(torch.abs(det) < _EPS, 0.0,
                          1.0 / torch.where(det == 0, 1.0, det))
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    tt = dot(e2, qvec) * inv_det
    ok = ((torch.abs(det) >= _EPS) & (u >= 0) & (v >= 0) & (u + v <= 1)
          & (tt > rays.tmin[:, None]) & (tt < rays.tmax[:, None]))
    tt = torch.where(ok, tt, float("inf"))
    best = torch.argmin(tt, dim=1)
    rows = torch.arange(tt.shape[0], device=tt.device)
    bt = tt[rows, best]
    hit = torch.isfinite(bt)
    n = normalize(cross(e1[rows, best], e2[rows, best]))
    return Hits(
        t=torch.where(hit, bt, rays.tmax),
        prim_id=torch.where(hit, best.to(torch.int32), -1).to(torch.int32),
        inst_id=torch.where(hit, 0, -1).to(torch.int32),
        mat_id=torch.where(hit, 0, -1).to(torch.int32),
        uv=torch.stack([u[rows, best], v[rows, best]], dim=-1),
        normal=torch.where(hit[:, None], n, 0.0))


def intersect_motion_triangles(geom: MotionTriangles, rays: Rays, times):
    """Closest hit of flat rays [N] at their times [N] (in [0, 1]) against
    the lerped triangles (motion.py:66-102) → Hits (mat_id 0 on a hit; the
    first of equal t)."""
    n, m = rays.tmin.shape[0], geom.num_triangles
    return prim_mod.cat_hits([
        _motion_tri_chunk(geom, prim_mod.ray_chunk(rays, a, b), times[a:b])
        for a, b in prim_mod.chunk_bounds(n, m)])


def _motion_sphere_chunk(c0, c1, radii, rays: Rays, times):
    c = c0[None] + times[:, None, None] * (c1 - c0)[None]
    o = rays.origin[:, None, :]
    d = rays.direction[:, None, :]
    oc = o - c
    b = dot(oc, d)
    cq = dot(oc, oc) - radii[None] * radii[None]
    disc = b * b - cq
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    tmin = rays.tmin[:, None]
    tt = torch.where(t0 > tmin, t0, t1)
    ok = (disc > 0) & (tt > tmin) & (tt < rays.tmax[:, None])
    tt = torch.where(ok, tt, float("inf"))
    best = torch.argmin(tt, dim=1)
    rows = torch.arange(tt.shape[0], device=tt.device)
    bt = tt[rows, best]
    hit = torch.isfinite(bt)
    p = rays.origin + bt[:, None] * rays.direction
    n = normalize(p - c[rows, best])
    ids = torch.where(hit, best.to(torch.int32), -1).to(torch.int32)
    return Hits(t=torch.where(hit, bt, rays.tmax), prim_id=ids,
                inst_id=torch.where(hit, 0, -1).to(torch.int32), mat_id=ids,
                uv=torch.zeros(bt.shape + (2,), dtype=torch.float32,
                               device=bt.device),
                normal=torch.where(hit[:, None], n, 0.0))


def intersect_motion_spheres(centers0, centers1, radii, rays: Rays, times):
    """Moving spheres (the motion sample's custom sphere): centres lerped at
    each ray's time (motion.py:105-136) → Hits (mat_id = the sphere's
    row)."""
    dev = rays.origin.device
    c0 = torch.as_tensor(centers0, dtype=torch.float32, device=dev)
    c1 = torch.as_tensor(centers1, dtype=torch.float32, device=dev)
    rr = torch.as_tensor(radii, dtype=torch.float32, device=dev)
    n = rays.tmin.shape[0]
    return prim_mod.cat_hits([
        _motion_sphere_chunk(c0, c1, rr, prim_mod.ray_chunk(rays, a, b),
                             times[a:b])
        for a, b in prim_mod.chunk_bounds(n, rr.shape[0])])


@dataclasses.dataclass
class SRTKey:
    """One SRT key: scale [3], unit quaternion [4] (x, y, z, w),
    translation [3]."""
    scale: torch.Tensor
    quat: torch.Tensor
    trans: torch.Tensor

    @classmethod
    def make(cls, device, scale=(1, 1, 1), quat=(0, 0, 0, 1),
             trans=(0, 0, 0)):
        q = torch.as_tensor(quat, dtype=torch.float32, device=device)
        return cls(scale=torch.as_tensor(scale, dtype=torch.float32,
                                         device=device),
                   quat=q / torch.linalg.vector_norm(q),
                   trans=torch.as_tensor(trans, dtype=torch.float32,
                                         device=device))


def _slerp(q0, q1, t):
    """Interpolation of unit quaternions [N, 4] at t [N] by the reference's
    rule: d is the sum of q0 * q1 over the whole batch (see the module
    doc), the shorter arc by its sign, a lerp where sin(theta) < 1e-4;
    renormalised."""
    d = torch.sum(q0 * q1)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.abs(d)
    theta = torch.arccos(torch.clamp(d, -1.0, 1.0))
    sin_t = torch.sin(theta)
    use_lerp = sin_t < 1e-4
    den = torch.clamp_min(sin_t, 1e-9)
    w0 = torch.where(use_lerp, 1.0 - t, torch.sin((1 - t) * theta) / den)
    w1 = torch.where(use_lerp, t, torch.sin(t * theta) / den)
    q = w0[..., None] * q0 + w1[..., None] * q1
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def _quat_rotate(q, v):
    """Rotate vectors v [..., 3] by quaternions q [..., 4]."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    t = 2.0 * cross(qv.expand_as(v), v)
    return v + qw * t + cross(qv.expand_as(t), t)


def _quat_conj(q):
    return q * torch.tensor([-1.0, -1.0, -1.0, 1.0], device=q.device)


def srt_interpolate(key0: SRTKey, key1: SRTKey, times):
    """The SRT at each ray's time → dict(scale [N, 3], quat [N, 4], trans
    [N, 3]): scale and translation lerped, rotation slerped."""
    t = times[:, None]
    n = times.shape[0]
    return dict(
        scale=key0.scale + t * (key1.scale - key0.scale),
        quat=_slerp(key0.quat.expand(n, 4), key1.quat.expand(n, 4), times),
        trans=key0.trans + t * (key1.trans - key0.trans))


def rays_to_object_space(rays: Rays, srt):
    """Rays into the object space of a per-ray SRT (object → world): the
    one-level motion-transform step. The direction keeps the scale, so t
    stays in world units."""
    inv_q = _quat_conj(srt["quat"])
    o = _quat_rotate(inv_q, rays.origin - srt["trans"]) / srt["scale"]
    d = _quat_rotate(inv_q, rays.direction) / srt["scale"]
    return Rays(origin=o, direction=d, tmin=rays.tmin, tmax=rays.tmax)


def hits_to_world_space(hits: Hits, srt):
    """Object-space hit normals back to world: divided by the scale (the
    normal transform), rotated, renormalised; 0 on a miss."""
    n = _quat_rotate(srt["quat"], hits.normal / srt["scale"])
    n = n / torch.clamp_min(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                            1e-12)
    return dataclasses.replace(
        hits, normal=torch.where(hits.valid[..., None], n, 0.0))
