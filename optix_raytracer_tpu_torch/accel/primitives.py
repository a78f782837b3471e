"""Analytic custom primitives: sphere, sphere shell, parallelogram and capsule
(counterpart of `accel/primitives.py:22-118, 121-465`, kinds 0-3).

A scene's custom prims live in one table and are tested brute force: every
ray against every prim, each kind by its closed-form solve. The fused
kernel (`csrc/pt_fused.cu`) repeats these formulas operation for operation,
so its hits equal the ones computed here.

The swept curve kinds (SWEPT_QUAD, SWEPT_CUBIC) are not ported yet
(ROADMAP.md Queue 1 item 9): `make_prims` stores them as the reference does,
and every query of a table that holds one raises NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.rays import Hits, Rays
from ..core.vecmath import cross, dot

SPHERE = 0
SPHERE_SHELL = 1
PARALLELOGRAM = 2
CAPSULE = 3        # round linear curve segment
SWEPT_QUAD = 4     # swept quadratic curve segment (not ported)
SWEPT_CUBIC = 5    # swept cubic curve segment (not ported)

PORTED_KINDS = (SPHERE, SPHERE_SHELL, PARALLELOGRAM, CAPSULE)
PARAM_COLS = 18
_BIG = 1e30


@dataclasses.dataclass
class CustomPrims:
    """Table of analytic primitives. params layout per kind:
      SPHERE:        [cx, cy, cz, r, 0...]
      SPHERE_SHELL:  [cx, cy, cz, r_inner, r_outer, 0...]
      PARALLELOGRAM: [ax, ay, az, v1x, v1y, v1z, v2x, v2y, v2z, 0...]
      CAPSULE:       [p0x, p0y, p0z, p1x, p1y, p1z, r, 0...]
    kinds_static mirrors `kind` as Python ints (the fused kernel's
    dispatch reads it without a device sync)."""
    kind: torch.Tensor     # [P] int32
    params: torch.Tensor   # [P, 18] f32
    mat_id: torch.Tensor   # [P] int32
    kinds_static: tuple = ()

    @property
    def num(self):
        return self.kind.shape[0]

    @classmethod
    def empty(cls, device):
        return cls(kind=torch.zeros((0,), dtype=torch.int32, device=device),
                   params=torch.zeros((0, PARAM_COLS), dtype=torch.float32,
                                      device=device),
                   mat_id=torch.zeros((0,), dtype=torch.int32, device=device))


def make_prims(prims, device) -> CustomPrims:
    """prims: list of dicts {kind, mat_id, center / radius / ... per kind}."""
    p = len(prims)
    kind = np.zeros(p, np.int32)
    params = np.zeros((p, PARAM_COLS), np.float32)
    mat = np.zeros(p, np.int32)
    for i, pr in enumerate(prims):
        kind[i] = pr["kind"]
        mat[i] = pr.get("mat_id", 0)
        if pr["kind"] == SPHERE:
            params[i, :3] = pr["center"]
            params[i, 3] = pr["radius"]
        elif pr["kind"] == SPHERE_SHELL:
            params[i, :3] = pr["center"]
            params[i, 3] = pr["radius_inner"]
            params[i, 4] = pr["radius_outer"]
        elif pr["kind"] == PARALLELOGRAM:
            params[i, :3] = pr["anchor"]
            params[i, 3:6] = pr["v1"]
            params[i, 6:9] = pr["v2"]
        elif pr["kind"] == CAPSULE:
            params[i, :3] = pr["p0"]
            params[i, 3:6] = pr["p1"]
            params[i, 6] = pr["radius"]
        elif pr["kind"] == SWEPT_QUAD:
            params[i, 0:3] = pr["a0"]
            params[i, 3:6] = pr["a1"]
            params[i, 6:9] = pr["a2"]
            params[i, 9:12] = pr["r"]
            params[i, 12:14] = pr.get("u_range", (0.0, 1.0))
        elif pr["kind"] == SWEPT_CUBIC:
            params[i, 0:3] = pr["a0"]
            params[i, 3:6] = pr["a1"]
            params[i, 6:9] = pr["a2"]
            params[i, 9:12] = pr["a3"]
            params[i, 12:16] = pr["r"]
            params[i, 16:18] = pr.get("u_range", (0.0, 1.0))
        else:
            raise ValueError(f"unknown prim kind {pr['kind']}")
    return CustomPrims(kind=torch.as_tensor(kind, device=device),
                       params=torch.as_tensor(params, device=device),
                       mat_id=torch.as_tensor(mat, device=device),
                       kinds_static=tuple(int(k) for k in kind))


def require_ported(prims: CustomPrims):
    """Raise for a table holding a kind the port cannot intersect yet."""
    swept = sorted({k for k in prims.kinds_static if k not in PORTED_KINDS})
    if swept:
        raise NotImplementedError(
            f"custom prim kinds {swept} (swept curve segments) are not "
            "ported yet (ROADMAP.md Queue 1 item 9)")


def _sphere_ts(o, d, center, radius):
    """Both sphere crossings (t_near, t_far); misses → +BIG."""
    oc = o - center
    b = dot(oc, d)
    c = dot(oc, oc) - radius * radius
    disc = b * b - c
    ok = disc > 0.0
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    return torch.where(ok, -b - sq, _BIG), torch.where(ok, -b + sq, _BIG)


def _prim_candidates(prims: CustomPrims, rays: Rays):
    """Every ray against every prim → t [N, P] (the nearest crossing in
    (tmin, tmax), BIG for none), normals [N, P, 3] and uv [N, P, 2] at that
    t. Sphere and shell normals face out from the centre, but inward on the
    shell's inner surface (picked by radius); capsule normals point away
    from the nearest axis point."""
    require_ported(prims)
    o = rays.origin[:, None, :]
    d = rays.direction[:, None, :]
    tmin = rays.tmin[:, None]
    tmax = rays.tmax[:, None]
    prm = prims.params[None]
    kind = prims.kind[None, :]
    center = prm[..., 0:3]

    # sphere (radius params[3]); shell (inner params[3], outer params[4])
    r_in = prm[..., 3]
    r_out = prm[..., 4]
    ts0, ts1 = _sphere_ts(o, d, center, r_in)
    to0, to1 = _sphere_ts(o, d, center, r_out)

    # parallelogram
    v1 = prm[..., 3:6]
    v2 = prm[..., 6:9]
    n_pg = cross(v1, v2)
    n_pg = n_pg / torch.clamp_min(torch.sqrt(dot(n_pg, n_pg)), 1e-20)[..., None]
    denom = dot(n_pg, d)
    safe_denom = torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)
    t_pg = dot(center - o, n_pg) / safe_denom
    rel = (o + t_pg[..., None] * d) - center
    a1 = dot(rel, v1) / torch.clamp_min(dot(v1, v1), 1e-20)
    a2 = dot(rel, v2) / torch.clamp_min(dot(v2, v2), 1e-20)
    pg_ok = ((torch.abs(denom) >= 1e-12) & (a1 >= 0.0) & (a1 <= 1.0)
             & (a2 >= 0.0) & (a2 <= 1.0))
    t_pg = torch.where(pg_ok, t_pg, _BIG)

    # capsule: the body, then the end caps on their outward halves
    pa = center
    ba = prm[..., 3:6] - pa
    r_cap = prm[..., 6]
    oa = o - pa
    baba = torch.clamp_min(dot(ba, ba), 1e-12)
    bard = dot(ba, d)
    baoa = dot(ba, oa)
    rdoa = dot(d, oa)
    oaoa = dot(oa, oa)
    a_c = baba - bard * bard
    b_c = baba * rdoa - baoa * bard
    c_c = baba * oaoa - baoa * baoa - r_cap * r_cap * baba
    h_c = b_c * b_c - a_c * c_c
    safe_a = torch.where(torch.abs(a_c) < 1e-12, 1e-12, a_c)
    t_body = (-b_c - torch.sqrt(torch.clamp_min(h_c, 0.0))) / safe_a
    y_c = baoa + t_body * bard
    body_ok = (h_c > 0.0) & (y_c > 0.0) & (y_c < baba)
    t_body = torch.where(body_ok, t_body, _BIG)

    def cap_valid(tc):
        yy = dot((o + tc[..., None] * d) - pa, ba)
        return torch.where((yy <= 0.0) | (yy >= baba), tc, _BIG)

    tc0a, tc0b = _sphere_ts(o, d, pa, r_cap)
    tc1a, tc1b = _sphere_ts(o, d, prm[..., 3:6], r_cap)
    # As the reference: the smallest cap crossing, range-checked after.
    t_cap = torch.minimum(torch.minimum(cap_valid(tc0a), cap_valid(tc0b)),
                          torch.minimum(cap_valid(tc1a), cap_valid(tc1b)))

    def pick(*ts):
        best = torch.full_like(ts[0], _BIG)
        for t in ts:
            best = torch.minimum(
                best, torch.where((t > tmin) & (t < tmax), t, _BIG))
        return best

    t = torch.where(kind == SPHERE, pick(ts0, ts1),
                    torch.where(kind == SPHERE_SHELL, pick(to0, to1, ts0, ts1),
                                torch.where(kind == CAPSULE,
                                            pick(t_body, t_cap),
                                            pick(t_pg))))

    # normals and uv at the chosen t
    p_hit = o + t[..., None] * d
    rel_c = p_hit - center
    rad = torch.sqrt(torch.clamp_min(dot(rel_c, rel_c), 1e-20))
    n_sphere = rel_c / rad[..., None]
    is_inner = torch.abs(rad - r_in) < torch.abs(rad - r_out)
    n_shell = torch.where(((kind == SPHERE_SHELL) & is_inner)[..., None],
                          -n_sphere, n_sphere)
    y_hit = torch.clamp(dot(p_hit - pa, ba) / baba, 0.0, 1.0)
    n_capsule = ((p_hit - (pa + y_hit[..., None] * ba))
                 / torch.clamp_min(r_cap, 1e-12)[..., None])
    is_pg = (kind == PARALLELOGRAM)[..., None]
    is_cap = (kind == CAPSULE)[..., None]
    normal = torch.where(is_pg, n_pg.expand_as(n_shell),
                         torch.where(is_cap, n_capsule, n_shell))
    sphere_uv = torch.stack(
        [0.5 + torch.atan2(rel_c[..., 2], rel_c[..., 0]) / (2 * math.pi),
         0.5 - torch.asin(torch.clamp(rel_c[..., 1] / rad, -1, 1)) / math.pi],
        dim=-1)
    uv = torch.where(is_pg, torch.stack([a1, a2], dim=-1),
                     torch.where(is_cap,
                                 torch.stack([y_hit, torch.zeros_like(y_hit)],
                                             dim=-1),
                                 sphere_uv))
    return t, normal, uv


def intersect_prims_closest(prims: CustomPrims, rays: Rays) -> Hits:
    """Closest hit over the custom-prim table (flat rays [N]); prim_id is
    the row of the table (the first of equal t)."""
    t, normal, uv = _prim_candidates(prims, rays)
    best = torch.argmin(t, dim=1)
    rows = torch.arange(t.shape[0], device=t.device)
    bt = t[rows, best]
    hit = bt < _BIG
    return Hits(
        t=torch.where(hit, bt, rays.tmax),
        prim_id=torch.where(hit, best.to(torch.int32), -1).to(torch.int32),
        inst_id=torch.where(hit, 0, -1).to(torch.int32),
        mat_id=torch.where(hit, prims.mat_id[best], -1).to(torch.int32),
        uv=uv[rows, best],
        normal=torch.where(hit[:, None], normal[rows, best], 0.0))


def intersect_prims_any(prims: CustomPrims, rays: Rays) -> torch.Tensor:
    t, _, _ = _prim_candidates(prims, rays)
    return torch.any(t < _BIG, dim=1)


def merge_hits(a: Hits, b: Hits, prim_offset: int = 0) -> Hits:
    """The nearer of two closest-hit results (a wins ties); b's prim ids get
    `prim_offset` added, so triangle and custom-prim ids stay disjoint."""
    b_wins = (b.prim_id >= 0) & ((a.prim_id < 0) | (b.t < a.t))

    def pick(x, y):
        return torch.where(b_wins if x.ndim == b_wins.ndim
                           else b_wins[..., None], y, x)

    return Hits(
        t=pick(a.t, b.t),
        prim_id=pick(a.prim_id, torch.where(b.prim_id >= 0,
                                            b.prim_id + prim_offset,
                                            -1).to(torch.int32)),
        inst_id=pick(a.inst_id, b.inst_id),
        mat_id=pick(a.mat_id, b.mat_id),
        uv=pick(a.uv, b.uv),
        normal=pick(a.normal, b.normal))
