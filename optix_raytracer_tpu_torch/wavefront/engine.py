"""The lock-step wavefront engine (counterpart of `wavefront/engine.py:85-189,
192-760, 772-921`) for diffuse and emissive materials: NEE toward the
parallelogram light, cosine bounces, Russian roulette.

The whole wavefront moves one bounce at a time, dead lanes masked. Its
intersections come from kernels 1 and 2 (brute force), or on a scene with a
cluster table from kernels 4-6, on CUDA, and from their plain versions on
the CPU. It is the fused kernel's oracle, as the XLA wavefront is the
Pallas megakernel's. On a cluster scene, the sequential, coherence-sorted
loop is the sample-major launch's oracle. It draws the RNG in the JAX
engine's order, including the glass pair that diffuse-only scenes never
read (engine.py:536).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..accel.clusters import coherence_key
from ..core import rng as _rng
from ..core.camera import generate_rays
from ..core.film import Film
from ..core.rays import Rays
from ..core.vecmath import dot
from ..scene.device_scene import DeviceScene
from ..shade import materials as mats
from ..shade.sampling import cosine_sample_hemisphere
from .intersect import scene_any, scene_closest

# Shadow / secondary-ray epsilons at Cornell scale, as in the JAX engine.
RAY_TMIN = 1e-2
SHADOW_TMAX_SCALE = 1.0 - 1e-3

IMPLS = ("auto", "fused", "wavefront", "spl")

# Rays per sample-major strip (engine.py:757-760): bounds the live wavefront
# state; a 1080p frame at 16 samples is 8 strips of 136 rows.
_SPL_TILE_RAYS = 4 * 1024 * 1024


def _nee_direct_light(scene: DeviceScene, hit_p, n, throughput_albedo, rng,
                      chunk_size, mask=None, group_walk=False):
    """Next-event estimation toward the parallelogram light: uniform point on
    the quad, weight nDl * LnDl * A / (pi d²) on the albedo-scaled throughput.
    Returns (contribution [N, 3], rng)."""
    light = scene.area_light
    u1, u2, rng = _rng.uniform2(rng)
    lp = light.corner + u1[..., None] * light.v1 + u2[..., None] * light.v2
    delta = lp - hit_p
    dist2 = torch.clamp_min(dot(delta, delta), 1e-12)
    dist = torch.sqrt(dist2)
    wi = delta / dist[..., None]
    n_dl = dot(n, wi)
    ln_dl = torch.abs(dot(light.normal.expand(wi.shape), wi))
    facing = n_dl > 0.0

    # Lanes whose contribution is masked out anyway get an empty window.
    shadow_live = facing if mask is None else (facing & mask)
    shadow_rays = Rays(origin=hit_p, direction=wi,
                       tmin=torch.full_like(dist, RAY_TMIN),
                       tmax=torch.where(shadow_live,
                                        dist * SHADOW_TMAX_SCALE, 0.0))
    occluded = scene_any(scene, shadow_rays, chunk_size=chunk_size,
                         group_walk=group_walk)
    weight = torch.where(facing & ~occluded,
                         n_dl * ln_dl * light.area / (math.pi * dist2), 0.0)
    contrib = throughput_albedo * light.emission * weight[..., None]
    return contrib, rng


def _bounce(scene: DeviceScene, state: dict, depth: int, chunk_size,
            exact: bool = False, group_walk: bool = False) -> dict:
    """One bounce of the whole wavefront (engine.py:241-611, the diffuse
    lanes): closest hit, miss and emission terms, NEE, cosine sampling and
    Russian roulette. Returns the next state."""
    rays = state["rays"]
    active = state["active"]
    throughput = state["throughput"]
    radiance = state["radiance"]
    rng = state["rng"]

    hits = scene_closest(scene, rays, chunk_size=chunk_size, exact=exact,
                         group_walk=group_walk)
    hit_valid = hits.valid & active

    # miss program: constant background
    radiance = radiance + torch.where((active & ~hits.valid)[..., None],
                                      throughput * scene.miss_color, 0.0)

    m = mats.gather(scene.materials, hits.mat_id)
    d = rays.direction
    # The cluster walk interpolates smooth normals in the kernel, so no
    # shading-frame epilogue follows it (engine.py:312-319).
    geom_n = hits.normal
    # two-sided shading normal, faceforward(N, -D, N)
    n = geom_n * torch.sign(-dot(geom_n, d))[..., None]
    hit_p = rays.at(hits.t)

    # Emission only on primary hits (or after a specular bounce, which
    # the diffuse-only slice never takes): NEE covers the rest.
    take_emission = hit_valid & state["prev_specular"]
    radiance = radiance + torch.where(take_emission[..., None],
                                      throughput * m["emission"], 0.0)

    # Every supported material is diffuse: NEE on all valid hits.
    t_albedo = throughput * m["base_color"]
    contrib, rng = _nee_direct_light(scene, hit_p, n, t_albedo, rng,
                                     chunk_size, mask=hit_valid,
                                     group_walk=group_walk)
    radiance = radiance + torch.where(hit_valid[..., None], contrib, 0.0)

    u1, u2, rng = _rng.uniform2(rng)
    new_dir = cosine_sample_hemisphere(u1, u2, n)
    _, _, rng = _rng.uniform2(rng)   # glass pair (engine.py:536), unused
    new_throughput = t_albedo        # f * cos / pdf = albedo

    offset_n = torch.where(dot(new_dir, n)[..., None] >= 0.0, n, -n)
    new_origin = hit_p + offset_n * RAY_TMIN

    # Russian roulette after depth 1
    u5, _, rng = _rng.uniform2(rng)
    q = torch.clamp(new_throughput.amax(dim=-1), 0.05, 1.0)
    if depth >= 1:
        survive = u5 < q
        new_throughput = new_throughput / q[..., None]
    else:
        survive = torch.ones_like(active)

    rays_traced = state["rays_traced"] + active.sum() + hit_valid.sum()
    active = hit_valid & survive
    out = dict(state)
    out.update(
        # Dead lanes get an empty ray window: the cluster cull drops whole
        # blocks of them.
        rays=Rays(origin=new_origin, direction=new_dir,
                  tmin=torch.full_like(hits.t, RAY_TMIN),
                  tmax=torch.where(active, 1e16, 0.0)),
        throughput=new_throughput, radiance=radiance, rng=rng,
        active=active, prev_specular=torch.zeros_like(active),
        rays_traced=rays_traced)
    return out


def _sort_wavefront(scene: DeviceScene, state: dict) -> dict:
    """Coherence-sort the whole path state for the next bounce
    (engine.py:146-189): one stable sort by `coherence_key`, every per-ray
    column permuted alike; dead rays go to the tail."""
    rays = state["rays"]
    perm = torch.argsort(coherence_key(scene.clusters, rays), stable=True)
    out = {k: (v[perm] if v.ndim else v)
           for k, v in state.items() if k != "rays"}
    out["rays"] = Rays(origin=rays.origin[perm], direction=rays.direction[perm],
                       tmin=rays.tmin[perm], tmax=rays.tmax[perm])
    return out


def trace_paths(scene: DeviceScene, rays: Rays, rng, max_depth: int = 4,
                chunk_size: Optional[int] = 65536, sample_major: bool = False,
                active0=None, group_walk: Optional[bool] = None):
    """Integrate radiance along a flat wavefront of camera rays.

    Returns (radiance [N, 3], rng [N], rays_traced int64 scalar tensor),
    where rays_traced counts closest-hit rays of live lanes plus the shadow
    rays of diffuse hits (the JAX engine's accounting, kept in int64).

    On a cluster scene (engine.py:613-658): a sample-major wavefront
    (consecutive lanes are the samples of one pixel, see
    render_sample_group) takes the interval cull at bounce 0 and the exact
    cull after it, in place, with the walk's group gating on; any other
    wavefront peels bounce 0, coherence-sorts the whole state before each
    later bounce, takes the exact cull with gating off, and is put back in
    pixel order at the end (the rng too). group_walk overrides the gating
    (it never changes a hit, only the work).
    active0 marks lanes that are live on arrival (strip padding is not).
    """
    scene.require_cornell_subset()
    n_rays = rays.tmin.shape[0]
    dev = rays.origin.device
    if active0 is None:
        active0 = torch.ones((n_rays,), dtype=torch.bool, device=dev)
    else:
        rays = Rays(origin=rays.origin, direction=rays.direction,
                    tmin=rays.tmin, tmax=torch.where(active0, rays.tmax, 0.0))
    state = dict(
        rays=rays,
        throughput=torch.ones((n_rays, 3), dtype=torch.float32, device=dev),
        radiance=torch.zeros((n_rays, 3), dtype=torch.float32, device=dev),
        rng=rng,
        active=active0,
        prev_specular=torch.ones_like(active0),   # depth-0 emission counts
        rays_traced=torch.zeros((), dtype=torch.int64, device=dev))

    if scene.has_clusters and sample_major:
        gw = True if group_walk is None else group_walk
        state = _bounce(scene, state, 0, chunk_size, group_walk=gw)
        for depth in range(1, max_depth):
            state = _bounce(scene, state, depth, chunk_size, exact=True,
                            group_walk=gw)
    elif scene.has_clusters:
        gw = bool(group_walk)
        state["pix"] = torch.arange(n_rays, device=dev)
        state = _bounce(scene, state, 0, chunk_size, group_walk=gw)
        for depth in range(1, max_depth):
            state = _bounce(scene, _sort_wavefront(scene, state), depth,
                            chunk_size, exact=True, group_walk=gw)
        pix = state["pix"]
        for key in ("radiance", "rng"):
            back = torch.empty_like(state[key])
            back[pix] = state[key]
            state[key] = back
    else:
        for depth in range(max_depth):
            state = _bounce(scene, state, depth, chunk_size)
    return state["radiance"], state["rng"], state["rays_traced"]


def render_sample(scene: DeviceScene, cam_params, width: int, height: int,
                  subframe, max_depth: int = 4,
                  chunk_size: Optional[int] = 65536,
                  y0=0, full_width=None, full_height=None):
    """One progressive sample of a [height, width] row tile → (radiance
    [H, W, 3], rays_traced). The RNG is seeded from the global pixel index
    and `subframe` (an int or an integer tensor on the device)."""
    dev = scene.device
    n = width * height
    full_w = width if full_width is None else full_width
    gy = torch.arange(height, dtype=torch.int64, device=dev)[:, None] + y0
    gx = torch.arange(width, dtype=torch.int64, device=dev)[None, :]
    pixel_idx = (gy * full_w + gx).reshape(n)
    if isinstance(subframe, torch.Tensor):
        subframe = subframe.to(dev)
    rng = _rng.seed(pixel_idx, subframe)
    rays, rng = generate_rays(cam_params, width, height,
                              rng_state=rng.reshape(height, width), y0=y0,
                              full_width=full_width, full_height=full_height)
    radiance, _, rays_traced = trace_paths(scene, rays.reshape(n),
                                           rng.reshape(n),
                                           max_depth=max_depth,
                                           chunk_size=chunk_size)
    return radiance.reshape(height, width, 3), rays_traced


def render_sample_group(scene: DeviceScene, cam_params, width: int,
                        height: int, subframe, spl: int, max_depth: int = 4,
                        chunk_size: Optional[int] = 65536, y0=0,
                        full_width=None, full_height=None):
    """`spl` progressive samples of a [height, width] tile traced as one
    sample-major wavefront (engine.py:706-754) → (radiance SUM [H, W, 3],
    rays_traced). Lane p*spl + s is sample s of pixel p, seeded
    seed(pixel_idx, subframe + s): the streams of the sequential loop.
    Rows past `full_height` (strip padding) are dead on arrival."""
    dev = scene.device
    n = width * height
    full_w = width if full_width is None else full_width
    full_h = height if full_height is None else full_height
    gy = torch.arange(height, dtype=torch.int64, device=dev)[:, None] + y0
    gx = torch.arange(width, dtype=torch.int64, device=dev)[None, :]
    pixel_idx = gy * full_w + gx                                  # [h, w]
    if isinstance(subframe, torch.Tensor):
        subframe = subframe.to(dev)
    sub = subframe + torch.arange(spl, dtype=torch.int64,
                                  device=dev)[:, None, None]      # [spl,1,1]
    rng = _rng.seed(pixel_idx[None], sub)                         # [spl,h,w]
    rays, rng = generate_rays(cam_params, width, height, rng_state=rng,
                              y0=y0, full_width=full_width,
                              full_height=full_height)

    def to_flat(a):
        return a.movedim(0, 2).reshape((n * spl,) + a.shape[3:])

    rays = Rays(origin=to_flat(rays.origin), direction=to_flat(rays.direction),
                tmin=to_flat(rays.tmin), tmax=to_flat(rays.tmax))
    in_frame = to_flat((gy < full_h)[None].expand(spl, height, width))
    radiance, _, rays_traced = trace_paths(
        scene, rays, to_flat(rng), max_depth=max_depth,
        chunk_size=chunk_size, sample_major=True, active0=in_frame)
    return radiance.reshape(height, width, spl, 3).sum(dim=2), rays_traced


def _use_fused(scene: DeviceScene, impl: str) -> bool:
    """`engine.py:772-821` minus its TPU test: the fused kernel on a CUDA
    device for a diffuse-only scene of at most MAX_FUSED_TRIS triangles."""
    from .pallas_pt import MAX_FUSED_MATS, MAX_FUSED_TRIS
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl != "auto":
        return impl == "fused"
    return (scene.device.type == "cuda"
            and not scene.features
            and scene.num_triangles <= MAX_FUSED_TRIS
            and scene.materials.num <= MAX_FUSED_MATS)


def _merge_launch(film: Film, rad_sum, samples_per_launch: int) -> Film:
    """Merge one launch's radiance SUM into the film: progressive mean plus
    one variance-tracker estimate per launch, the same for both paths."""
    prev_n = film.subframe.to(torch.float32)
    new_n = float(samples_per_launch)
    accum = (film.accum * prev_n + rad_sum) / (prev_n + new_n)
    sq, launches = film.sq, film.launches
    if sq is not None:
        est = rad_sum / new_n
        tl = 1.0 / (launches.to(torch.float32) + 1.0)
        sq = sq + (est * est - sq) * tl
        launches = launches + 1
    return Film(accum=accum, subframe=film.subframe + samples_per_launch,
                sq=sq, launches=launches)


def render_accumulate(scene: DeviceScene, cam_params, film: Film, width: int,
                      height: int, samples_per_launch: int = 1,
                      max_depth: int = 4,
                      chunk_size: Optional[int] = 65536,
                      y0=0, full_width=None, full_height=None,
                      impl: str = "auto"):
    """Add `samples_per_launch` samples to the film → (film, rays_traced).

    impl: "fused" runs the fused path-trace kernel (kernel 3; its plain
    version on the CPU); "wavefront" the lock-step engine one sample after
    another (on CUDA its intersections come from kernels 1-2, or kernels
    4-6 on a cluster scene); "spl" the sample-major engine in strips of
    about _SPL_TILE_RAYS rays (render_sample_group); "auto" the fused
    kernel where `_use_fused` allows it, else "spl" on a cluster scene with
    at least 8 samples per launch, else "wavefront". All consume identical
    RNG streams. On a cluster scene the walk's group gating is on for
    "spl" and off for "wavefront" (trace_paths).
    """
    if _use_fused(scene, impl):
        from . import pallas_pt
        rad_sum, rays = pallas_pt.render_sum_fused(
            scene, cam_params, width, height, film.subframe,
            samples_per_launch=samples_per_launch, max_depth=max_depth,
            y0=y0, full_width=full_width, full_height=full_height)
        return _merge_launch(film, rad_sum, samples_per_launch), rays
    if impl == "spl" or (impl == "auto" and scene.has_clusters
                         and samples_per_launch >= 8):
        rad_sum, count = render_sum_sample_major(
            scene, cam_params, width, height, film.subframe,
            samples_per_launch, max_depth=max_depth, chunk_size=chunk_size,
            y0=y0, full_width=full_width, full_height=full_height)
    else:
        rad_sum, count = render_sum_wavefront(
            scene, cam_params, width, height, film.subframe,
            samples_per_launch, max_depth=max_depth, chunk_size=chunk_size,
            y0=y0, full_width=full_width, full_height=full_height)
    return _merge_launch(film, rad_sum, samples_per_launch), count


def render_sum_sample_major(scene: DeviceScene, cam_params, width: int,
                            height: int, subframe, samples_per_launch: int,
                            max_depth: int = 4,
                            chunk_size: Optional[int] = 65536, y0=0,
                            full_width=None, full_height=None):
    """`samples_per_launch` samples as sample-major strips of `rows` rows,
    each about _SPL_TILE_RAYS rays (engine.py:872-904) → (radiance SUM
    [H, W, 3], rays_traced)."""
    rows = min(height, max(1, _SPL_TILE_RAYS
                           // max(width * samples_per_launch, 1)))
    n_strips = -(-height // rows)
    rad_sum = torch.zeros((n_strips * rows, width, 3), dtype=torch.float32,
                          device=scene.device)
    count = torch.zeros((), dtype=torch.int64, device=scene.device)
    for i in range(n_strips):
        r, c = render_sample_group(
            scene, cam_params, width, rows, subframe, samples_per_launch,
            max_depth=max_depth, chunk_size=chunk_size, y0=y0 + i * rows,
            full_width=full_width if full_width is not None else width,
            full_height=full_height if full_height is not None else height)
        rad_sum[i * rows:(i + 1) * rows] = r
        count = count + c
    return rad_sum[:height], count


def render_sum_wavefront(scene: DeviceScene, cam_params, width: int,
                         height: int, subframe, samples_per_launch: int,
                         max_depth: int = 4,
                         chunk_size: Optional[int] = 65536,
                         y0=0, full_width=None, full_height=None):
    """`samples_per_launch` sequential `render_sample`s from `subframe` →
    (radiance SUM [H, W, 3], rays_traced)."""
    rad_sum = torch.zeros((height, width, 3), dtype=torch.float32,
                          device=scene.device)
    count = torch.zeros((), dtype=torch.int64, device=scene.device)
    for i in range(samples_per_launch):
        radiance, rays_traced = render_sample(
            scene, cam_params, width, height, subframe + i,
            max_depth=max_depth, chunk_size=chunk_size, y0=y0,
            full_width=full_width, full_height=full_height)
        rad_sum = rad_sum + radiance
        count = count + rays_traced
    return rad_sum, count
