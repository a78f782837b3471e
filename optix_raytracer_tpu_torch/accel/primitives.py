"""Analytic custom primitives: sphere, sphere shell, parallelogram, capsule
and the swept quadratic and cubic curve spans (counterpart of
`accel/primitives.py:22-118, 121-465`, kinds 0-5).

A scene's custom prims live in one table and are tested brute force: every
ray against every prim, each kind by its closed-form solve, the swept spans
by the reference's lock-step solver (a coarse scan of _SWEPT_COARSE + 1
points, _SWEPT_NEWTON Newton steps, a swept-sphere fix-point). The fused
kernel (`csrc/pt_fused.cu`) takes kinds 0-3 and repeats their formulas
operation for operation, so its hits equal the ones computed here. The
swept branch runs only for a table whose `kinds_static` holds kind 4 or 5:
a table of kinds 0-3 computes exactly what it did before the swept kinds
were ported.

The rays are taken in chunks so that no [chunk, P] plane holds more than
PLANE_ELEMS elements (the swept solver keeps tens of such planes alive);
each ray's answer does not depend on its chunk. The swept solver's Newton
steps divide and take square roots whose last ulp may differ from XLA's,
so a ray that grazes a strand may flip; the tests count such rays.
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
SWEPT_QUAD = 4     # swept quadratic curve span (round quadratic B-spline)
SWEPT_CUBIC = 5    # swept cubic curve span (B-spline / Catmull-Rom / Bézier)

PORTED_KINDS = (SPHERE, SPHERE_SHELL, PARALLELOGRAM, CAPSULE, SWEPT_QUAD,
                SWEPT_CUBIC)
SWEPT_KINDS = (SWEPT_QUAD, SWEPT_CUBIC)
PARAM_COLS = 18
_BIG = 1e30
_SWEPT_COARSE = 16  # coarse scan points of the curve parameter (phi is of
                    # degree 6 for a cubic: up to 3 local minima)
_SWEPT_NEWTON = 6   # Newton steps on the scan's minimiser
# The most elements of one [chunk, P] plane (64 MiB of f32).
PLANE_ELEMS = 1 << 24


def chunk_bounds(n, m):
    """[(a, b)] row ranges of n rays such that a [b - a, m] plane holds at
    most PLANE_ELEMS elements (one empty range for n = 0)."""
    step = max(1, PLANE_ELEMS // max(m, 1))
    return [(i, min(n, i + step)) for i in range(0, n, step)] or [(0, 0)]


def ray_chunk(rays: Rays, a, b) -> Rays:
    return Rays(origin=rays.origin[a:b], direction=rays.direction[a:b],
                tmin=rays.tmin[a:b], tmax=rays.tmax[a:b])


def cat_hits(parts) -> Hits:
    """Per-chunk Hits of consecutive ray ranges → one Hits."""
    if len(parts) == 1:
        return parts[0]
    return Hits(**{f: torch.cat([getattr(h, f) for h in parts])
                   for f in ("t", "prim_id", "inst_id", "mat_id", "uv",
                             "normal")})


@dataclasses.dataclass
class CustomPrims:
    """Table of analytic primitives. params layout per kind:
      SPHERE:        [cx, cy, cz, r, 0...]
      SPHERE_SHELL:  [cx, cy, cz, r_inner, r_outer, 0...]
      PARALLELOGRAM: [ax, ay, az, v1x, v1y, v1z, v2x, v2y, v2z, 0...]
      CAPSULE:       [p0x, p0y, p0z, p1x, p1y, p1z, r, 0...]
      SWEPT_QUAD:    [a0(3), a1(3), a2(3), r0, r1, r2, u0, u1, 0...]
        C(s) = a0 + a1 s + a2 s², r(s) = r0 + r1 s + r2 s² on s in [0, 1]
      SWEPT_CUBIC:   [a0(3), a1(3), a2(3), a3(3), r0, r1, r2, r3, u0, u1]
        the same of degree 3; (u0, u1) is the span's range of strand u
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
    """Raise for a table holding a kind outside PORTED_KINDS."""
    unknown = sorted({k for k in prims.kinds_static if k not in PORTED_KINDS})
    if unknown:
        raise ValueError(f"unknown custom prim kinds {unknown}")


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
    swept = None
    if any(k in SWEPT_KINDS for k in prims.kinds_static):
        swept = _SweptSpans(prm, kind, o, d)
        is_swq = (kind == SWEPT_QUAD) | (kind == SWEPT_CUBIC)
        t = torch.where(is_swq, pick(swept.t), t)

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
    if swept is not None:
        n_sw, uv_sw = swept.frame(p_hit)
        normal = torch.where(is_swq[..., None], n_sw, normal)
        uv = torch.where(is_swq[..., None], uv_sw, uv)
    return t, normal, uv


class _SweptSpans:
    """The swept-span solver over [N, P] planes (primitives.py:209-335,
    381-394): a quadratic span is a cubic with a3 = r3 = 0. phi(s) =
    |perp(C(s) - o)|² - r(s)², degree 6 in s (perp: the part orthogonal to
    the unit ray direction), is scanned at _SWEPT_COARSE + 1 points for
    two candidates, its minimiser and the in-basin point of the nearest
    sphere entry; the minimiser takes _SWEPT_NEWTON clipped Newton steps;
    each candidate is refined by the swept-sphere fix-point (the best t of
    every evaluation is kept) and the nearer wins. `t` [N, P] is the entry
    (BIG where none), `frame(p_hit)` the outward normal and the uv, (the
    strand u of the span's u range at the curve point nearest the hit, 0),
    as the reference gives them."""

    def __init__(self, prm, kind, o, d):
        is_cub = kind == SWEPT_CUBIC
        self.is_cub = is_cub
        self.prm = prm
        self.o, self.d = o, d
        self.sa0 = prm[..., 0:3]
        self.sa1 = prm[..., 3:6]
        self.sa2 = prm[..., 6:9]
        self.sa3 = torch.where(is_cub[..., None], prm[..., 9:12], 0.0)
        sr0 = torch.where(is_cub, prm[..., 12], prm[..., 9])
        sr1 = torch.where(is_cub, prm[..., 13], prm[..., 10])
        sr2 = torch.where(is_cub, prm[..., 14], prm[..., 11])
        sr3 = torch.where(is_cub, prm[..., 15], 0.0)
        self.sr = (sr0, sr1, sr2, sr3)

        def perp(v):
            return v - dot(v, d)[..., None] * d

        q0 = perp(self.sa0 - o)
        q1 = perp(self.sa1)
        q2 = perp(self.sa2)
        q3 = perp(self.sa3)
        A0 = dot(q0, q0) - sr0 * sr0
        A1 = 2 * dot(q0, q1) - 2 * sr0 * sr1
        A2 = dot(q1, q1) + 2 * dot(q0, q2) - (sr1 * sr1 + 2 * sr0 * sr2)
        A3 = 2 * (dot(q0, q3) + dot(q1, q2)) - 2 * (sr0 * sr3 + sr1 * sr2)
        A4 = (dot(q2, q2) + 2 * dot(q1, q3)
              - (sr2 * sr2 + 2 * sr1 * sr3))
        A5 = 2 * dot(q2, q3) - 2 * sr2 * sr3
        A6 = dot(q3, q3) - sr3 * sr3
        del q0, q1, q2, q3

        def phi(sv):
            return A0 + sv * (A1 + sv * (A2 + sv * (
                A3 + sv * (A4 + sv * (A5 + sv * A6)))))

        # the coarse scan: the phi minimiser, and the in-basin point with
        # the smallest sphere entry (a ray passing a curled strand twice)
        shape = A0.shape
        s_best = torch.zeros(shape, dtype=torch.float32, device=o.device)
        phi_best = torch.full_like(s_best, _BIG)
        s_tmin = torch.zeros_like(s_best)
        t_scan = torch.full_like(s_best, _BIG)
        for kk in range(_SWEPT_COARSE + 1):
            sv = torch.full_like(s_best, kk / _SWEPT_COARSE)
            ph = phi(sv)
            closer = ph < phi_best
            s_best = torch.where(closer, sv, s_best)
            phi_best = torch.where(closer, ph, phi_best)
            te, ok = self._sphere_entry(sv)
            tt = torch.where(ph < 0.0, torch.where(ok & (te > 0.0), te, _BIG),
                             _BIG)
            nearer = tt < t_scan
            s_tmin = torch.where(nearer, sv, s_tmin)
            t_scan = torch.where(nearer, tt, t_scan)
        # Newton on the minimiser (phi' of degree 5, phi'' of degree 4), the
        # step clipped so a flat phi'' cannot fling s out of its basin
        for _ in range(_SWEPT_NEWTON):
            dphi = A1 + s_best * (2 * A2 + s_best * (
                3 * A3 + s_best * (4 * A4 + s_best * (
                    5 * A5 + s_best * 6 * A6))))
            ddphi = 2 * A2 + s_best * (6 * A3 + s_best * (
                12 * A4 + s_best * (20 * A5 + s_best * 30 * A6)))
            stepn = dphi / torch.where(torch.abs(ddphi) < 1e-9, 1e-9, ddphi)
            s_best = torch.clamp(s_best - torch.clamp(stepn, -0.25, 0.25),
                                 0.0, 1.0)
        s_a, t_a = self._refine(s_best)
        t_a = torch.where(phi_best < 0.0, t_a, _BIG)
        s_b, t_b = self._refine(s_tmin)
        t_b = torch.where(t_scan < _BIG, t_b, _BIG)
        self.s = torch.where(t_b < t_a, s_b, s_a)
        self.t = torch.minimum(t_a, t_b)

    def _curve_pt(self, sv):
        s1 = sv[..., None]
        return self.sa0 + s1 * (self.sa1 + s1 * (self.sa2 + s1 * self.sa3))

    def _curve_r(self, sv):
        sr0, sr1, sr2, sr3 = self.sr
        return torch.clamp_min(sr0 + sv * (sr1 + sv * (sr2 + sv * sr3)), 1e-6)

    def _sphere_entry(self, sv):
        """The entry t of the ray into the ball B(C(s), r(s)), and whether
        it crosses the ball."""
        oc = self.o - self._curve_pt(sv)
        rr = self._curve_r(sv)
        b = dot(oc, self.d)
        c = dot(oc, oc) - rr * rr
        disc = b * b - c
        return -b - torch.sqrt(torch.clamp_min(disc, 0.0)), disc > 0.0

    def _project(self, s, p):
        """Two Newton steps on psi(s) = (C(s) - p) . C'(s): the curve
        parameter nearest p."""
        sa1, sa2, sa3 = self.sa1, self.sa2, self.sa3
        for _ in range(2):
            cc = self._curve_pt(s)
            s1 = s[..., None]
            cd = sa1 + s1 * (2.0 * sa2 + s1 * 3.0 * sa3)
            cdd = 2.0 * sa2 + s1 * 6.0 * sa3
            psi = dot(cc - p, cd)
            dpsi = dot(cd, cd) + dot(cc - p, cdd)
            s = torch.clamp(
                s - psi / torch.where(torch.abs(dpsi) < 1e-9, 1e-9, dpsi),
                0.0, 1.0)
        return s

    def _refine(self, s):
        """The swept-sphere fix-point from s: every per-s sphere entry of
        an outside origin bounds the true entry from above, so the smallest
        valid t over all evaluations is kept, never the last."""
        t, ok = self._sphere_entry(s)
        s_out = s
        t_out = torch.where(ok, t, _BIG)
        for _ in range(2):
            s = self._project(s, self.o + t[..., None] * self.d)
            t, ok = self._sphere_entry(s)
            tv = torch.where(ok, t, _BIG)
            better = tv < t_out
            s_out = torch.where(better, s, s_out)
            t_out = torch.where(better, tv, t_out)
        return s_out, t_out

    def frame(self, p_hit):
        """(normal [N, P, 3], uv [N, P, 2]) at the hit points."""
        s_n = self._project(self.s, p_hit)
        n = (p_hit - self._curve_pt(s_n)) / self._curve_r(s_n)[..., None]
        n = n / torch.clamp_min(torch.sqrt(dot(n, n)), 1e-12)[..., None]
        prm, is_cub = self.prm, self.is_cub
        su0 = torch.where(is_cub, prm[..., 16], prm[..., 12])
        su1 = torch.where(is_cub, prm[..., 17], prm[..., 13])
        u = su0 + (su1 - su0) * s_n
        return n, torch.stack([u, torch.zeros_like(u)], dim=-1)


def _closest_chunk(prims: CustomPrims, rays: Rays) -> Hits:
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


def intersect_prims_closest(prims: CustomPrims, rays: Rays) -> Hits:
    """Closest hit over the custom-prim table (flat rays [N]); prim_id is
    the row of the table (the first of equal t)."""
    return cat_hits([_closest_chunk(prims, ray_chunk(rays, a, b))
                     for a, b in chunk_bounds(rays.tmin.shape[0], prims.num)])


def intersect_prims_any(prims: CustomPrims, rays: Rays) -> torch.Tensor:
    return torch.cat([
        torch.any(_prim_candidates(prims, ray_chunk(rays, a, b))[0] < _BIG,
                  dim=1)
        for a, b in chunk_bounds(rays.tmin.shape[0], prims.num)])


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
