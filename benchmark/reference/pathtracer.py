"""Plain reference path tracer: the estimator the benchmark holds the port to.

It works out again, from the scene arrays, the cameras and the subframes the
benchmark hands the port, what a launch adds to chosen pixels of the film:

- the RNG streams: TEA seeding from (pixel index, subframe), then the PCG
  counter hash, one uniform from the top 24 bits of a word (the OptiX SDK's
  `random.h`);
- ray generation: the pinhole camera's jittered ray through the pixel
  (`sutil::Camera`'s U, V, W frame), then the thin-lens pair, drawn and unused;
- closest-hit and any-hit queries: Moller-Trumbore against every triangle,
  the first triangle at the least t winning;
- shading: diffuse materials, emission on the camera hit, next-event
  estimation toward the parallelogram light with a shadow query, a cosine
  bounce about the two-sided normal (smooth normals interpolated where the
  scene has them), the unused glass pair, Russian roulette after the first
  bounce;
- the film merge: the progressive mean over the samples of every launch.

Per path the draws are: the jitter pair, the lens pair, then per bounce the
NEE pair, the cosine pair, the glass pair and the roulette pair. Rays are
counted as the engine counts them: each closest-hit ray of a live path and
each shadow ray of a hit.

Plain PyTorch on any device. Every floating tensor is of `dtype`: float32 for
the reference, bfloat16 for the benchmark's control. It imports nothing of the
program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
CAMERA_TMIN = 1e-4
RAY_TMIN = 1e-2
SHADOW_TMAX_SCALE = 1.0 - 1e-3
FAR = 1e16
# Elements of one [rays, triangles] block of an intersection query.
BLOCK_ELEMS = 1 << 25
# Paths traced together.
LANES = 1 << 20


# --------------------------------------------------------------------------
# RNG: 32-bit words carried in int64
# --------------------------------------------------------------------------

def _mul32(a, c):
    """(a * c) mod 2**32 for int64 a in [0, 2**32) and a 32-bit constant c,
    from 16-bit halves of c so that no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def tea(v0, v1, rounds=4):
    """TEA hash of two 32-bit words (int64 tensors) → the seed word."""
    s = 0
    for _ in range(rounds):
        s = (s + 0x9E3779B9) & MASK32
        v0 = (v0 + (((v1 << 4) + 0xA341316C) ^ (v1 + s)
                    ^ ((v1 >> 5) + 0xC8013EA4))) & MASK32
        v1 = (v1 + (((v0 << 4) + 0xAD90777D) ^ (v0 + s)
                    ^ ((v0 >> 5) + 0x7E95761E))) & MASK32
    return v0


def next_uniform(state, dtype):
    """One PCG step → (uniform in [0, 1) of `dtype`, next state)."""
    state = (_mul32(state, 747796405) + 2891336453) & MASK32
    x = _mul32(state ^ (state >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    u = (x >> 8).to(torch.float32) * (1.0 / 16777216.0)
    return u.to(dtype), state


def uniform_pair(state, dtype):
    u1, state = next_uniform(state, dtype)
    u2, state = next_uniform(state, dtype)
    return u1, u2, state


# --------------------------------------------------------------------------
# Vectors as [..., 3] tensors
# --------------------------------------------------------------------------

def dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def normalize(a):
    return a / torch.sqrt(torch.clamp_min(dot(a, a), 1e-20))[..., None]


# --------------------------------------------------------------------------
# Camera
# --------------------------------------------------------------------------

def camera_frame(eye, lookat, up, fov_y, aspect):
    """The pinhole camera's U, V, W (float32 numpy): W from the eye to the
    look-at point, U and V across the image plane, scaled by the field of
    view and the aspect ratio (`sutil/Camera.cpp`)."""
    eye = np.asarray(eye, np.float32)
    lookat = np.asarray(lookat, np.float32)
    up = np.asarray(up, np.float32)
    w = lookat - eye
    wlen = np.linalg.norm(w)
    u = np.cross(w, up)
    u /= max(np.linalg.norm(u), 1e-20)
    v = np.cross(u, w)
    v /= max(np.linalg.norm(v), 1e-20)
    vlen = wlen * math.tan(0.5 * math.radians(fov_y))
    ulen = vlen * aspect
    return (np.asarray(u * ulen, np.float32), np.asarray(v * vlen, np.float32),
            np.asarray(w, np.float32))


# --------------------------------------------------------------------------
# Scene
# --------------------------------------------------------------------------

class Scene:
    """The scene arrays on `device` in `dtype`: triangles as v0 / e1 / e2
    columns, per-triangle material rows, per-corner normals (smooth scenes),
    the parallelogram light and the background."""

    def __init__(self, arrays, device, dtype=torch.float32):
        self.dtype, self.device = dtype, device

        def f(x):
            return torch.as_tensor(np.asarray(x, np.float32),
                                   device=device).to(dtype)

        verts = np.asarray(arrays["vertices"], np.float32)
        idx = np.asarray(arrays["indices"], np.int64)
        v0 = verts[idx[:, 0]]
        e1 = verts[idx[:, 1]] - v0
        e2 = verts[idx[:, 2]] - v0
        self.num_triangles = idx.shape[0]
        # [3, M] columns, one row per coordinate
        self.v0, self.e1, self.e2 = f(v0.T), f(e1.T), f(e2.T)
        self.face_normal = normalize(cross(f(e1), f(e2)))
        normals = arrays.get("normals")
        self.corner_normal = (None if normals is None
                              else f(np.asarray(normals, np.float32)[idx]))
        mats = arrays["materials"]
        for m in mats:
            if m.get("kind", "diffuse") != "diffuse":
                raise ValueError(f"the reference shades diffuse materials "
                                 f"only, not {m['kind']!r}")
        self.albedo = f([m["base_color"] for m in mats])
        self.emission = f([m.get("emission", (0.0, 0.0, 0.0)) for m in mats])
        self.tri_mat = torch.as_tensor(np.asarray(arrays["tri_mat"], np.int64),
                                       device=device)
        light = arrays["light"]
        self.light_corner = f(light["corner"])
        self.light_v1 = f(light["v1"])
        self.light_v2 = f(light["v2"])
        self.light_emission = f(light["emission"])
        c = cross(self.light_v1, self.light_v2)
        self.light_normal = normalize(c)
        self.light_area = torch.sqrt(dot(c, c))
        self.miss_color = f(arrays.get("miss_color", (0.0, 0.0, 0.0)))


def _mt_block(scene, lo, hi, o, d, tmin, tmax):
    """Moller-Trumbore of rays [n] against triangles lo:hi → (t with inf
    where rejected, u, v), each [n, hi - lo]."""
    v0, e1, e2 = (x[:, None, lo:hi] for x in (scene.v0, scene.e1, scene.e2))
    ox, oy, oz = (o[:, k, None] for k in range(3))
    dx, dy, dz = (d[:, k, None] for k in range(3))
    px = dy * e2[2] - dz * e2[1]
    py = dz * e2[0] - dx * e2[2]
    pz = dx * e2[1] - dy * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    inv = 1.0 / det
    sx, sy, sz = ox - v0[0], oy - v0[1], oz - v0[2]
    u = (sx * px + sy * py + sz * pz) * inv
    qx = sy * e1[2] - sz * e1[1]
    qy = sz * e1[0] - sx * e1[2]
    qz = sx * e1[1] - sy * e1[0]
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv
    ok = ((det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1)
          & (t > tmin[:, None]) & (t < tmax[:, None]))
    return torch.where(ok, t, torch.inf), u, v


def _chunks(scene, n):
    """(ray rows, triangle blocks) of at most BLOCK_ELEMS pairs a block."""
    m = scene.num_triangles
    rows = max(1, BLOCK_ELEMS // m)
    tris = max(1, BLOCK_ELEMS // min(rows, max(n, 1)))
    return ([(s, min(s + rows, n)) for s in range(0, n, rows)],
            [(lo, min(lo + tris, m)) for lo in range(0, m, tris)])


def closest_hit(scene, o, d, tmin, tmax):
    """→ (t [n], prim [n] int64, -1 on a miss, u [n], v [n])."""
    n = o.shape[0]
    best_t = torch.full((n,), torch.inf, dtype=scene.dtype, device=o.device)
    best = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    row_chunks, tri_blocks = _chunks(scene, n)
    for s, e in row_chunks:
        for lo, hi in tri_blocks:
            t, u, v = _mt_block(scene, lo, hi, o[s:e], d[s:e], tmin[s:e],
                                tmax[s:e])
            j = torch.argmin(t, dim=1, keepdim=True)
            tj = t.gather(1, j)[:, 0]
            better = tj < best_t[s:e]   # strict: earlier triangles win ties
            best_t[s:e] = torch.where(better, tj, best_t[s:e])
            best[s:e] = torch.where(better, j[:, 0] + lo, best[s:e])
            best_u[s:e] = torch.where(better, u.gather(1, j)[:, 0],
                                      best_u[s:e])
            best_v[s:e] = torch.where(better, v.gather(1, j)[:, 0],
                                      best_v[s:e])
    return best_t, best, best_u, best_v


def occluded(scene, o, d, tmin, tmax):
    n = o.shape[0]
    occ = torch.zeros((n,), dtype=torch.bool, device=o.device)
    row_chunks, tri_blocks = _chunks(scene, n)
    for s, e in row_chunks:
        for lo, hi in tri_blocks:
            t, _, _ = _mt_block(scene, lo, hi, o[s:e], d[s:e], tmin[s:e],
                                tmax[s:e])
            occ[s:e] |= torch.isfinite(t).any(dim=1)
    return occ


def _on_live(live, fn, *cols):
    """fn over the live lanes only; dead lanes get fn's empty answer."""
    idx = torch.nonzero(live)[:, 0]
    return idx, fn(*(c[idx] for c in cols))


# --------------------------------------------------------------------------
# Sampling
# --------------------------------------------------------------------------

def cosine_hemisphere(u1, u2, n):
    """Cosine-weighted direction about unit n: the concentric disk lifted to
    the hemisphere, in the branchless Frisvad / Duff basis of n."""
    ox = 2.0 * u1 - 1.0
    oy = 2.0 * u2 - 1.0
    x_major = torch.abs(ox) > torch.abs(oy)
    r = torch.where(x_major, ox, oy)
    safe_ox = torch.where(ox == 0.0, 1.0, ox)
    safe_oy = torch.where(oy == 0.0, 1.0, oy)
    theta = torch.where(x_major, (math.pi / 4.0) * (oy / safe_ox),
                        (math.pi / 2.0) - (math.pi / 4.0) * (ox / safe_oy))
    r = torch.where((ox == 0.0) & (oy == 0.0), 0.0, r)
    dx, dy = r * torch.cos(theta), r * torch.sin(theta)
    dz = torch.sqrt(torch.clamp_min(1.0 - dx * dx - dy * dy, 0.0))
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    bt = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return normalize(dx[..., None] * t + dy[..., None] * bt
                     + dz[..., None] * n)


# --------------------------------------------------------------------------
# Paths
# --------------------------------------------------------------------------

def trace_paths(scene, o, d, state, max_depth):
    """Paths from camera rays (o, d [n, 3]) and RNG states [n] → (radiance
    [n, 3], rays [n] int64)."""
    dt, dev = scene.dtype, o.device
    n = o.shape[0]
    throughput = torch.ones((n, 3), dtype=dt, device=dev)
    radiance = torch.zeros((n, 3), dtype=dt, device=dev)
    rays = torch.zeros((n,), dtype=torch.int64, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    tmin = torch.full((n,), CAMERA_TMIN, dtype=dt, device=dev)
    for depth in range(max_depth):
        tmax = torch.where(active, FAR, 0.0).to(dt)
        t = torch.full((n,), FAR, dtype=dt, device=dev)
        prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
        u = torch.zeros((n,), dtype=dt, device=dev)
        v = torch.zeros((n,), dtype=dt, device=dev)
        idx, (ti, pi, ui, vi) = _on_live(
            active, lambda *c: closest_hit(scene, *c), o, d, tmin, tmax)
        t[idx], prim[idx], u[idx], v[idx] = ti, pi, ui, vi
        hit = (prim >= 0) & active
        radiance = radiance + torch.where(
            (active & ~hit)[:, None], throughput * scene.miss_color, 0.0)

        tri = torch.clamp_min(prim, 0)
        mat = scene.tri_mat[tri]
        albedo = scene.albedo[mat]
        emission = scene.emission[mat]
        if scene.corner_normal is None:
            geom_n = scene.face_normal[tri]
        else:
            cn = scene.corner_normal[tri]
            w = (1.0 - u) - v
            geom_n = normalize(w[:, None] * cn[:, 0] + u[:, None] * cn[:, 1]
                               + v[:, None] * cn[:, 2])
        n_shade = geom_n * torch.sign(-dot(geom_n, d))[:, None]
        p = o + t[:, None] * d
        if depth == 0:   # emission on camera hits; NEE covers the rest
            radiance = radiance + torch.where(hit[:, None],
                                              throughput * emission, 0.0)
        t_albedo = throughput * albedo

        # next-event estimation toward the parallelogram light
        u1, u2, state = uniform_pair(state, dt)
        lp = (scene.light_corner + u1[:, None] * scene.light_v1
              + u2[:, None] * scene.light_v2)
        delta = lp - p
        dist2 = torch.clamp_min(dot(delta, delta), 1e-12)
        dist = torch.sqrt(dist2)
        wi = delta / dist[:, None]
        n_dl = dot(n_shade, wi)
        ln_dl = torch.abs(dot(scene.light_normal.expand_as(wi), wi))
        facing = n_dl > 0.0
        shadow = hit & facing
        occ = torch.zeros((n,), dtype=torch.bool, device=dev)
        sidx, socc = _on_live(
            shadow, lambda *c: occluded(scene, *c), p, wi,
            torch.full((n,), RAY_TMIN, dtype=dt, device=dev),
            dist * SHADOW_TMAX_SCALE)
        occ[sidx] = socc
        weight = torch.where(facing & ~occ,
                             n_dl * ln_dl * scene.light_area
                             / (math.pi * dist2), 0.0)
        radiance = radiance + torch.where(
            hit[:, None], t_albedo * scene.light_emission * weight[:, None],
            0.0)

        # cosine bounce, the glass pair (unused), roulette after depth 0
        u1, u2, state = uniform_pair(state, dt)
        new_d = cosine_hemisphere(u1, u2, n_shade)
        _, _, state = uniform_pair(state, dt)
        off = torch.where((dot(new_d, n_shade) >= 0.0)[:, None], n_shade,
                          -n_shade)
        new_o = p + off * RAY_TMIN
        u5, _, state = uniform_pair(state, dt)
        q = torch.clamp(t_albedo.amax(dim=-1), 0.05, 1.0)
        new_t = t_albedo
        survive = torch.ones_like(active)
        if depth >= 1:
            survive = u5 < q
            new_t = new_t / q[:, None]

        rays = rays + active.to(torch.int64) + hit.to(torch.int64)
        active = hit & survive
        o, d, throughput = new_o, new_d, new_t
        tmin = torch.full((n,), RAY_TMIN, dtype=dt, device=dev)
    return radiance, rays


def render_pixels(scene, cameras, px, py, width, height, subframes, spl,
                  max_depth):
    """What each launch adds at the chosen pixels.

    cameras: dict of [L, 3] float32 arrays "eye", "U", "V", "W" (one row a
    launch); px, py: [L, P] int pixel columns and rows of each launch;
    subframes: [L] the film's
    subframe at each launch; spl samples a launch, sample s of launch l seeded
    from (pixel index, subframes[l] + s). → (radiance sums [L, P, 3] in
    the scene's dtype, summed over the samples in their order, and rays
    [L, P] int64)."""
    dt, dev = scene.dtype, scene.device
    px, py = np.asarray(px, np.int64), np.asarray(py, np.int64)
    L, P = px.shape
    cam = {k: torch.as_tensor(np.asarray(cameras[k], np.float32),
                              device=dev).to(dt)
           for k in ("eye", "U", "V", "W")}
    px_t = torch.as_tensor(px.reshape(-1), device=dev)
    py_t = torch.as_tensor(py.reshape(-1), device=dev)
    sub_t = torch.as_tensor(np.asarray(subframes, np.int64), device=dev)
    fw = torch.full((), width, dtype=dt, device=dev)
    fh = torch.full((), height, dtype=dt, device=dev)
    total = L * P * spl
    rad = torch.zeros((total, 3), dtype=dt, device=dev)
    rays = torch.zeros((total,), dtype=torch.int64, device=dev)
    for s0 in range(0, total, LANES):
        lane = torch.arange(s0, min(total, s0 + LANES), device=dev)
        sample = lane % spl
        launch = lane // (spl * P)
        x, y = px_t[lane // spl], py_t[lane // spl]
        state = tea((y * width + x) & MASK32,
                    (sub_t[launch] + sample) & MASK32)
        jx, jy, state = uniform_pair(state, dt)
        _, _, state = uniform_pair(state, dt)        # the thin-lens pair
        ndx = 2.0 * ((x.to(dt) + jx) / fw) - 1.0
        ndy = 1.0 - 2.0 * ((y.to(dt) + jy) / fh)
        d = normalize(ndx[:, None] * cam["U"][launch]
                      + ndy[:, None] * cam["V"][launch] + cam["W"][launch])
        o = cam["eye"][launch]
        r, c = trace_paths(scene, o, d, state, max_depth)
        rad[lane] = r
        rays[lane] = c
    rad = rad.reshape(L, P, spl, 3)
    acc = rad[:, :, 0]
    for s in range(1, spl):
        acc = acc + rad[:, :, s]
    return acc, rays.reshape(L, P, spl).sum(dim=2)


def merge_films(sums, subframes, spl, reset):
    """The film at the chosen pixels after each launch: the progressive mean
    (film * n + sum) / (n + spl), n the film's samples before the launch;
    with `reset` the film restarts before every launch. sums [L, P, 3] →
    films [L, P, 3] in the sums' dtype (on the CPU)."""
    sums = sums.cpu()
    film = torch.zeros_like(sums[0])
    out = torch.empty_like(sums)
    for k in range(sums.shape[0]):
        if reset:
            film = torch.zeros_like(film)
        n = torch.tensor(float(subframes[k]), dtype=sums.dtype)
        film = (film * n + sums[k]) / (n + float(spl))
        out[k] = film
    return out
