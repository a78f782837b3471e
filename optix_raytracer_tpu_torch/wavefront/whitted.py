"""The Whitted integrator (counterpart of `wavefront/whitted.py`): phong,
checker, glass, mirror and metallic-roughness GGX shading under the scene's
light table (point, ambient, directional, volumetric), a shadow query per
light, and one continuation ray a bounce: the mirror direction, or for glass
reflection or refraction picked by Schlick Fresnel. On a textured scene
the textured lane: the shading frame's normal, and the base map read
bilinearly at the frame's uv (`shade/texture.py::sample_bilinear`) scales
the diffuse color. On a scene with alpha cutouts the shadow queries
re-enter past holes (`intersect.scene_any`); radiance rays see the cut
surfaces, as in the reference.

The whole wavefront moves one bounce at a time in eager PyTorch. Its queries
go through `intersect.scene_closest` / `scene_any`: kernels 1-2 on a flat
mesh, kernels 4-6 (or 7-8 for any-hit under ORT_QWALK=1) on a cluster
table, custom prims merged in by torch ops. Per bounce and lane the RNG is
drawn in the reference's order: two pairs per light (sample_light), then the
glass pair, whatever the material. The reference traces every lane at every
bounce; here a lane that has ended, and a shadow ray whose contribution is
masked out, gets an empty window (tmax 0): the kernels count it as dead,
and a lane that missed never hands the cluster cull its far-away origin.
The values that are kept are the same.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..accel.geometry import shading_frame
from ..accel.tlas import world_shading_normal
from ..core import rng as _rng
from ..core.camera import generate_rays
from ..core.film import Film
from ..core.rays import Rays
from ..core.vecmath import dot, normalize, reflect, refract
from ..scene.device_scene import DeviceScene
from ..shade import materials as mats
from ..shade.lights import sample_light
from ..shade.texture import sample_bilinear
from .engine import INV_PI, RAY_TMIN, SHADOW_TMAX_SCALE, _pow5
from .intersect import scene_any, scene_closest

# The material fields the Whitted bounce reads.
FIELDS = ("kind", "base_color", "emission", "metallic", "roughness", "ior",
          "kr", "specular", "phong_exp", "checker1", "checker_scale",
          "base_tex")


def _checker(uv, scale):
    """The procedural checker mask from the surface uv."""
    cu = torch.floor(uv[..., 0] * scale)
    cv = torch.floor(uv[..., 1] * scale)
    return torch.remainder(cu + cv, 2.0) < 1.0


def _surface(scene: DeviceScene, hits, m):
    """The hit's normal and its base map's color (whitted.py:67-97) → (normal
    [N, 3], albedo factor [N, 3] or None). On a smooth or textured mesh a
    triangle hit takes the shading frame's interpolated normal; on a
    textured one the base map (sample_bilinear, level 0, at the frame's uv;
    white where a material has none or the hit is a prim's) gives the
    factor. On an instanced scene the interpolated normal goes back to
    world by the hit instance's inverse, as the path engine's does
    (tlas.world_shading_normal); the reference's Whitted integrator shades
    with the object-space normal there (whitted.py:71-94), which the
    render of the same meshes baked into world space does not."""
    if not (scene.geom.smooth or scene.has_textures):
        return hits.normal, None
    n_tri = scene.num_triangles
    is_tri = hits.prim_id < n_tri
    frame = shading_frame(scene.geom, torch.clamp(hits.prim_id, 0, n_tri - 1),
                          hits.uv)
    if scene.has_instances:
        normal = world_shading_normal(scene.instances, hits, is_tri,
                                      frame["shading_normal"])
    else:
        normal = torch.where(is_tri[..., None], frame["shading_normal"],
                             hits.normal)
    if not scene.has_textures:
        return normal, None
    rgba = sample_bilinear(scene.textures, scene.tex_size,
                           torch.where(is_tri, m["base_tex"], -1),
                           frame["uv"])
    return normal, rgba[..., :3]


def _direct(m, kd, n, d, refl_view, wi, lrad, is_ambient, lit):
    """One light's term (whitted.py:119-171): phongShade's lobes, kd·nDl
    (unnormalised) + ks·max(r·wi, 1e-6)^exp, or on PBR lanes the GGX
    metallic-roughness BRDF; an ambient light adds kd·radiance."""
    wo = -d
    n_dv = torch.clamp_min(dot(n, wo), 1e-4)
    n_dl = torch.clamp_min(dot(n, wi), 0.0)
    is_pbr = m["kind"] == mats.PBR
    rough = torch.clamp_min(m["roughness"], 0.05)
    a = rough * rough
    alpha2 = a * a
    metal = m["metallic"]
    f0 = (0.04 * (1.0 - metal))[..., None] + metal[..., None] * kd
    spec_phong = m["specular"] * torch.pow(
        torch.clamp_min(dot(refl_view, wi), 1e-6), m["phong_exp"])[..., None]
    h = normalize(wi + wo)
    n_dh = torch.clamp_min(dot(n, h), 0.0)
    denom_d = n_dh * n_dh * (alpha2 - 1.0) + 1.0
    dist_d = alpha2 / torch.clamp_min(math.pi * denom_d * denom_d, 1e-8)
    k_g = (rough + 1.0) * (rough + 1.0) * 0.125
    g_v = n_dv / (n_dv * (1 - k_g) + k_g)
    g_l = n_dl / torch.clamp_min(n_dl * (1 - k_g) + k_g, 1e-8)
    fres = f0 + (1.0 - f0) * _pow5(
        1.0 - torch.clamp_min(dot(h, wo), 0.0))[..., None]
    spec_ggx = fres * (dist_d * g_v * g_l
                       / torch.clamp_min(4.0 * n_dv * n_dl, 1e-8))[..., None]
    spec = torch.where(is_pbr[..., None], spec_ggx * n_dl[..., None],
                       spec_phong)
    kd_pbr = kd * (1.0 - metal)[..., None] * INV_PI
    diff_term = torch.where(is_pbr[..., None],
                            kd_pbr * n_dl[..., None] * math.pi,
                            kd * n_dl[..., None])
    term = torch.where(is_ambient[..., None], kd * lrad,
                       (diff_term + spec) * lrad)
    return term * lit[..., None]


def _bounce(scene: DeviceScene, state: dict, chunk_size) -> dict:
    """One bounce of the whole wavefront (whitted.py:54-203) → the next
    state."""
    rays = state["rays"]
    active = state["active"]
    throughput = state["throughput"]
    radiance = state["radiance"]
    rng = state["rng"]

    hits = scene_closest(scene, rays, chunk_size=chunk_size)
    hit_valid = hits.valid & active
    radiance = radiance + torch.where((active & ~hits.valid)[..., None],
                                      throughput * scene.miss_color, 0.0)

    m = mats.gather(scene.materials, hits.mat_id, FIELDS)
    d = rays.direction
    geom_n, albedo_tex = _surface(scene, hits, m)
    n = geom_n * torch.sign(-dot(geom_n, d))[..., None]
    hit_p = rays.at(hits.t)

    kind = m["kind"]
    is_glass = kind == mats.GLASS
    is_mirror = ((kind == mats.PBR) & (m["metallic"] > 0.99)
                 & (m["roughness"] <= 0.05))
    is_phongish = ~(is_glass | is_mirror)
    radiance = radiance + torch.where(hit_valid[..., None],
                                      throughput * m["emission"], 0.0)

    # the checker selects its diffuse color by the procedural mask
    on_primary = _checker(hits.uv, m["checker_scale"])
    kd = torch.where(((kind == mats.CHECKER) & ~on_primary)[..., None],
                     m["checker1"], m["base_color"])
    if albedo_tex is not None:
        kd = kd * albedo_tex
    refl_view = normalize(reflect(d, n))

    # per light: its sample, a shadow query (cast for an ambient light too,
    # whose result is then ignored), its term
    shaded = hit_valid & is_phongish
    direct = torch.zeros_like(kd)
    rays_traced = state["rays_traced"] + active.sum()
    for li in range(scene.lights.num):
        wi, dist, lrad, is_ambient, rng = sample_light(scene.lights, li,
                                                       hit_p, rng)
        shadow = Rays(origin=hit_p, direction=wi,
                      tmin=torch.full_like(dist, RAY_TMIN),
                      tmax=torch.where(shaded, dist * SHADOW_TMAX_SCALE, 0.0))
        occ = scene_any(scene, shadow, chunk_size=chunk_size)
        n_dl = torch.clamp_min(dot(n, wi), 0.0)
        lit = torch.where(is_ambient, 1.0,
                          (~occ).to(torch.float32)
                          * torch.where(n_dl > 0, 1.0, 0.0))
        direct = direct + _direct(m, kd, n, d, refl_view, wi, lrad,
                                  is_ambient, lit)
        rays_traced = rays_traced + shaded.sum()
    radiance = radiance + torch.where(shaded[..., None], throughput * direct,
                                      0.0)

    # the continuation ray: glass reflects or refracts by Schlick Fresnel,
    # everything else takes the mirror direction
    ior = m["ior"]
    eta = torch.where(dot(d, geom_n) < 0.0, 1.0 / ior, ior)
    d_refr, refr_ok = refract(d, n, eta)
    cos_i = torch.clamp(-dot(d, n), 0.0, 1.0)
    r = (ior - 1.0) / (ior + 1.0)
    r0 = r * r
    fresnel = r0 + (1.0 - r0) * _pow5(1.0 - cos_i)
    u, _, rng = _rng.uniform2(rng)
    gl_reflect = (~refr_ok) | (u < fresnel)
    d_glass = torch.where(gl_reflect[..., None], refl_view,
                          normalize(d_refr))
    new_dir = torch.where(is_glass[..., None], d_glass, refl_view)

    # throughput: the material's kr; a zero kr ends the path
    kr = m["kr"]
    continues = hit_valid & (kr > 0.0).any(dim=-1)
    offset_n = torch.where(dot(new_dir, n)[..., None] >= 0.0, n, -n)
    return dict(
        rays=Rays(origin=hit_p + offset_n * RAY_TMIN, direction=new_dir,
                  tmin=torch.full_like(hits.t, RAY_TMIN),
                  tmax=torch.where(continues, 1e16, 0.0)),
        throughput=throughput * kr, radiance=radiance, rng=rng,
        active=continues, rays_traced=rays_traced)


def trace_whitted(scene: DeviceScene, rays: Rays, rng, max_depth: int = 8,
                  chunk_size: Optional[int] = 65536):
    """Whitted radiance of a flat wavefront [N] → (radiance [N, 3], rng [N],
    rays_traced int64 scalar tensor: the closest-hit rays of live lanes plus
    the shadow rays of the shaded hits, one per light)."""
    scene.require_supported()
    n_rays = rays.tmin.shape[0]
    dev = rays.origin.device
    state = dict(
        rays=rays,
        throughput=torch.ones((n_rays, 3), dtype=torch.float32, device=dev),
        radiance=torch.zeros((n_rays, 3), dtype=torch.float32, device=dev),
        rng=rng,
        active=torch.ones((n_rays,), dtype=torch.bool, device=dev),
        rays_traced=torch.zeros((), dtype=torch.int64, device=dev))
    for _ in range(max_depth):
        state = _bounce(scene, state, chunk_size)
    return state["radiance"], state["rng"], state["rays_traced"]


def render_whitted_sample(scene: DeviceScene, cam_params, width: int,
                          height: int, subframe, max_depth: int = 8,
                          chunk_size: Optional[int] = 65536):
    """One jittered Whitted sample of the whole frame → (radiance [H, W, 3],
    rays_traced). The RNG is seeded from the pixel index and `subframe` (an
    int or an integer tensor on the device)."""
    dev = scene.device
    n = width * height
    if isinstance(subframe, torch.Tensor):
        subframe = subframe.to(dev)
    rng = _rng.seed(torch.arange(n, dtype=torch.int64, device=dev), subframe)
    rays, rng = generate_rays(cam_params, width, height,
                              rng_state=rng.reshape(height, width))
    radiance, _, rays_traced = trace_whitted(
        scene, rays.reshape(n), rng.reshape(n), max_depth=max_depth,
        chunk_size=chunk_size)
    return radiance.reshape(height, width, 3), rays_traced


def render_whitted(scene: DeviceScene, cam_params, width: int, height: int,
                   samples: int, max_depth: int = 8):
    """`samples` progressive samples accumulated into a new film, each
    seeded from the film's subframe, as the Whitted and meshviewer apps
    render → (Film, rays_traced)."""
    film = Film.create(height, width, scene.device)
    rays = torch.zeros((), dtype=torch.int64, device=scene.device)
    for _ in range(samples):
        radiance, r = render_whitted_sample(scene, cam_params, width, height,
                                            film.subframe,
                                            max_depth=max_depth)
        film = film.accumulate(radiance)
        rays = rays + r
    return film, rays
