"""Fog volumes over dense density grids (counterpart of `accel/volume.py`):
trilinear sampling, fixed-step optical depth, distance sampling of one
scatter point a segment, single scattering toward the area light, a
directional shadow sweep, and the standalone ray march of the volume
viewer; `pyroclastic_ball` is the demo grid.

Every march takes the reference's fixed step count as a plain Python loop
of torch ops, so a ray's answer does not depend on the others. A grid is
indexed [z, y, x] and may be non-cubic (a NanoVDB grid). Divisions by a
step count or a cell count divide by a tensor on the grids' device: a CUDA
division by a Python scalar multiplies by its f32 reciprocal, which rounds
apart from the CPU's and XLA's true division unless the count is a power
of two. `sample_grid` clips to res - 1.001 before its floor, as the
reference does; a point on a cell boundary may still floor apart from XLA
after a 1-ulp difference upstream, which the tests count.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.aabb import intersect_ray
from ..core.rays import Rays


@dataclasses.dataclass
class DensityGrid:
    """A dense density volume in a world box: density [D, H, W] f32 in
    (z, y, x) order, lo [3] and hi [3] its world corners."""
    density: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor

    @classmethod
    def empty(cls, device):
        return cls(density=torch.zeros((1, 1, 1), dtype=torch.float32,
                                       device=device),
                   lo=torch.zeros((3,), dtype=torch.float32, device=device),
                   hi=torch.ones((3,), dtype=torch.float32, device=device))

    @classmethod
    def from_numpy(cls, density, lo, hi, device):
        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return cls(density=f32(density).contiguous(), lo=f32(lo), hi=f32(hi))


def _div(x, k):
    """x / k as a true division on every device (see the module doc)."""
    return x / torch.full((), float(k), dtype=torch.float32, device=x.device)


def sample_grid(grid: DensityGrid, pts):
    """Trilinear density at world points [..., 3], 0 outside the box (the
    box's faces are inside) → [...]."""
    res = torch.tensor(grid.density.shape[::-1], dtype=torch.float32,
                       device=pts.device)                       # (x, y, z)
    g = (pts - grid.lo) / (grid.hi - grid.lo) * (res - 1)
    inside = torch.all((pts >= grid.lo) & (pts <= grid.hi), dim=-1)
    g = torch.minimum(torch.clamp_min(g, 0.0), res - 1.001)
    i0 = torch.floor(g).to(torch.int64)
    f = g - i0
    # Every point but a NaN one (outside, so masked below) floors into
    # [0, res - 2] already (a 1-voxel axis floors to -1); the clamps keep
    # the gathers in the grid, as XLA's gather clamps its indices.
    last = torch.tensor(grid.density.shape[::-1], device=pts.device) - 1
    i1 = torch.minimum(torch.clamp_min(i0 + 1, 0), last)
    i0 = torch.minimum(torch.clamp_min(i0, 0), last)
    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    x1, y1, z1 = i1[..., 0], i1[..., 1], i1[..., 2]
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    d = grid.density

    def at(dx, dy, dz):
        return d[z1 if dz else z0, y1 if dy else y0, x1 if dx else x0]

    c00 = at(0, 0, 0) * (1 - fx) + at(1, 0, 0) * fx
    c10 = at(0, 1, 0) * (1 - fx) + at(1, 1, 0) * fx
    c01 = at(0, 0, 1) * (1 - fx) + at(1, 0, 1) * fx
    c11 = at(0, 1, 1) * (1 - fx) + at(1, 1, 1) * fx
    val = ((c00 * (1 - fy) + c10 * fy) * (1 - fz)
           + (c01 * (1 - fy) + c11 * fy) * fz)
    return torch.where(inside, val, 0.0)


def _segment_window(grid: DensityGrid, origin, direction, t0, t1):
    """[t0, t1] clipped to the grid's box → (near, span >= 0)."""
    inv_d = 1.0 / torch.where(torch.abs(direction) < 1e-12, 1e-12, direction)
    a = (grid.lo - origin) * inv_d
    b = (grid.hi - origin) * inv_d
    t_enter = torch.amax(torch.minimum(a, b), dim=-1)
    t_exit = torch.amin(torch.maximum(a, b), dim=-1)
    near = torch.maximum(t0, t_enter)
    far = torch.minimum(t1, t_exit)
    return near, torch.clamp_min(far - near, 0.0)


def optical_depth(grid: DensityGrid, origin, direction, t0, t1, sigma_t,
                  num_steps: int = 16):
    """tau along [t0, t1] by midpoint quadrature in `num_steps` steps (the
    transmittance exp(-tau) of the viewer's closest-hit program)."""
    near, span = _segment_window(grid, origin, direction, t0, t1)
    dt = _div(span, num_steps)
    tau = torch.zeros_like(t0)
    for i in range(num_steps):
        p = origin + (near + (i + 0.5) * dt)[..., None] * direction
        tau = tau + sample_grid(grid, p) * dt
    return tau * sigma_t


def sample_scatter(grid: DensityGrid, origin, direction, t0, t1, sigma_t, u,
                   num_steps: int = 16):
    """One scatter distance along [t0, t1], distributed as sigma_t(t) T(t)
    on the marched optical depth (inverse transform of its cumulative sum)
    → (t_s, w = 1 - exp(-tau_total), tau_total), each [N]."""
    near, span = _segment_window(grid, origin, direction, t0, t1)
    dt = _div(span, num_steps)
    dtaus = torch.stack([
        sample_grid(grid, origin + (near + (i + 0.5) * dt)[..., None]
                    * direction) * dt * sigma_t
        for i in range(num_steps)])                          # [S, N]
    cum = torch.cumsum(dtaus, dim=0)
    tau_total = cum[-1]
    w = -torch.expm1(-tau_total)
    target = -torch.log1p(-torch.clamp(u, 0.0, 1.0 - 1e-6) * w)
    idx = torch.clamp((cum < target[None]).sum(dim=0), 0, num_steps - 1)
    cum_start = torch.where(
        idx > 0, torch.gather(cum, 0, torch.clamp_min(idx - 1, 0)[None])[0],
        0.0)
    dtau_i = torch.gather(dtaus, 0, idx[None])[0]
    frac = torch.clamp((target - cum_start)
                       / torch.where(dtau_i > 1e-12, dtau_i, 1e-12), 0.0, 1.0)
    t_s = near + (idx.to(torch.float32) + frac) * dt
    return t_s, w, tau_total


def segment_scatter_nee(grid: DensityGrid, origin, direction, t0, t1,
                        sigma_t, scatter_albedo, light, num_steps: int = 16,
                        light_steps: int = 8):
    """Single scattering along [t0, t1] toward the centre of a parallelogram
    light, with an isotropic phase and a short optical-depth march toward
    the light per step → (tau [N], inscatter [N, 3])."""
    near, span = _segment_window(grid, origin, direction, t0, t1)
    dt = _div(span, num_steps)
    lc = light.corner + 0.5 * light.v1 + 0.5 * light.v2
    four_pi = torch.full((), 4.0 * math.pi, dtype=torch.float32,
                         device=t0.device)
    tau = torch.zeros_like(t0)
    rad = torch.zeros(t0.shape + (3,), dtype=torch.float32, device=t0.device)
    for i in range(num_steps):
        t = near + (i + 0.5) * dt
        p = origin + t[..., None] * direction
        dtau = sigma_t * sample_grid(grid, p) * dt
        trans_cam = torch.exp(-tau)
        delta = lc - p
        dist2 = torch.clamp_min(torch.sum(delta * delta, dim=-1), 1e-12)
        dist = torch.sqrt(dist2)
        wi = delta / dist[..., None]
        ln_dl = torch.abs(torch.sum(light.normal * wi, dim=-1))
        tau_l = optical_depth(grid, p, wi, torch.zeros_like(dist), dist,
                              sigma_t, num_steps=light_steps)
        li = (light.emission[None, :]
              * (ln_dl * light.area / dist2 / four_pi)[..., None]
              * torch.exp(-tau_l)[..., None])
        rad = rad + (trans_cam * scatter_albedo * dtau)[..., None] * li
        tau = tau + dtau
    return tau, rad


def light_transmittance_grid(grid: DensityGrid, light_dir, sigma_t: float):
    """Per-voxel transmittance toward a directional light, by a cumulative
    optical-depth sweep along the light's dominant axis (a host tuple)."""
    ld = np.asarray(light_dir, np.float32)
    axis = int(np.argmax(np.abs(ld)))
    sign = float(np.sign(ld[axis]))
    d = grid.density
    arr_axis = 2 - axis                    # the array is (z, y, x)
    cell = _div(grid.hi[axis] - grid.lo[axis], d.shape[arr_axis])
    tau = torch.cumsum(d, dim=arr_axis) * cell * sigma_t
    if sign > 0:      # light travelling +axis: upstream is the far side
        total = torch.sum(d, dim=arr_axis, keepdim=True) * cell * sigma_t
        tau = total - tau
    return torch.exp(-tau)


def march(grid: DensityGrid, rays: Rays, light_dir, light_color,
          sigma_t: float = 8.0, ambient=0.15, num_steps: int = 96,
          bg_radiance=None, bg_t=None):
    """Single-scattering fixed-step march of flat rays [N] → (radiance
    [N, 3], transmittance [N]), composited over bg_radiance [N, 3] whose
    depth bg_t [N] ends the march (the viewer's mesh behind the cloud)."""
    n = rays.tmin.shape[0]
    dev = rays.origin.device
    inv_d = 1.0 / rays.direction
    _, t_enter = intersect_ray(grid.lo, grid.hi, rays.origin, inv_d,
                               rays.tmin, rays.tmax)
    t0 = (grid.lo - rays.origin) * inv_d
    t1 = (grid.hi - rays.origin) * inv_d
    t_exit = torch.amin(torch.maximum(t0, t1), dim=-1)
    t_far = torch.minimum(t_exit, bg_t if bg_t is not None else rays.tmax)
    t_near = torch.maximum(t_enter, rays.tmin)
    seg = torch.clamp_min(t_far - t_near, 0.0)
    dt = _div(seg, num_steps)
    shadow_grid = DensityGrid(
        density=light_transmittance_grid(grid, light_dir, sigma_t),
        lo=grid.lo, hi=grid.hi)
    light_color = torch.as_tensor(light_color, dtype=torch.float32,
                                  device=dev)
    trans = torch.ones((n,), dtype=torch.float32, device=dev)
    rad = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    for i in range(num_steps):
        t = t_near + (i + 0.5) * dt
        p = rays.origin + t[:, None] * rays.direction
        alpha = sigma_t * sample_grid(grid, p) * dt
        light_t = sample_grid(shadow_grid, p)
        inscatter = ((light_color[None, :] * light_t[:, None] + ambient)
                     * alpha[:, None])
        rad = rad + trans[:, None] * inscatter
        trans = trans * torch.exp(-alpha)
    if bg_radiance is not None:
        rad = rad + trans[:, None] * bg_radiance
    return rad, trans


def pyroclastic_ball(res: int = 64, seed: int = 0, *, device):
    """The demo puffball (the viewer's default volume): a radial falloff
    warped by trilinear value noise from default_rng(seed), built in numpy
    bit for bit as the reference builds it, in [-1, 1]³, on `device`."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 1, (9, 9, 9)).astype(np.float32)
    zoom = res / 8.0
    idx = np.minimum((np.arange(res) / zoom), 7.999)
    i0 = idx.astype(np.int32)
    f = (idx - i0).astype(np.float32)

    def lerp_axis(a, axis):
        sl0 = np.take(a, i0, axis=axis)
        sl1 = np.take(a, np.minimum(i0 + 1, 8), axis=axis)
        shape = [1, 1, 1]
        shape[axis] = res
        return sl0 + (sl1 - sl0) * f.reshape(shape)

    noise = lerp_axis(lerp_axis(lerp_axis(coarse, 0), 1), 2)
    zz, yy, xx = np.meshgrid(*([np.linspace(-1, 1, res)] * 3), indexing="ij")
    r = np.sqrt(xx * xx + yy * yy + zz * zz)
    dens = np.clip(0.72 + 0.45 * noise - r, 0.0, 1.0)
    return DensityGrid.from_numpy(dens, (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0),
                                  device)
