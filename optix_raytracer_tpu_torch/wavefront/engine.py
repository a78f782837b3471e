"""The lock-step wavefront engine (counterpart of `wavefront/engine.py:44-189,
192-760, 772-921`): diffuse, emissive, glass, mirror and PBR (metallic-
roughness GGX) materials; NEE toward the parallelogram light (the full BRDF
on PBR lanes), cosine, one-sample-MIS GGX and Fresnel glass bounces,
Russian roulette; on a textured scene the texture lanes: the bundle fetch
(`shade/texture.py`) at the ray cone's mip level, and the base-color,
metallic-roughness, emissive and normal maps; on a scene with alpha cutouts
the cut lanes: a hit in a hole passes straight through, unshaded and never
ended by roulette, and its shadow rays re-enter past holes
(`intersect.scene_any`); on a scene with moving triangles one shutter time a
path, which every query of the path receives; on a scene with a fog volume
the volume lanes: a scatter point a segment (`accel/volume.sample_scatter`)
lit by the area light through a shadow query and the volume's
transmittance, the segment's transmittance on the throughput, and the
transmittance toward the light on NEE.

The whole wavefront moves one bounce at a time, dead lanes masked. Its
intersections come from kernels 1 and 2 (brute force, once per instance on
an instanced scene), or on a scene with a cluster table from kernels 4-6,
on CUDA, and from their plain versions on the CPU; custom prims are merged
in by torch ops; smooth meshes shade with the shading-frame epilogue. It is
the fused kernel's oracle, as the XLA wavefront is the Pallas megakernel's,
and the fused kernel repeats its arithmetic operation for operation. On a
cluster scene, the sequential, coherence-sorted loop is the sample-major
launch's oracle. It draws the RNG in the JAX engine's order: with motion,
first of all the path's shutter time (the first value of a pair, the second
thrown away, engine.py:212-217); per bounce, with a volume, two pairs
(u_s, u_l1, then u_l2; engine.py:262-263) before the surface's draws; then
the NEE pair, the cosine pair, two GGX pairs when the scene has PBR lanes,
the glass pair (drawn even where no lane reads it, engine.py:536) and the
roulette pair. One draw out of place moves every later sample.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch

from .. import telemetry
from ..accel import volume as vol
from ..accel.clusters import QUERIES as CLUSTER_QUERIES, coherence_key
from ..accel.geometry import shading_frame
from ..accel.micromap import TRANSPARENT, micro_index
from ..accel.tlas import world_shading_normal
from ..core import rng as _rng
from ..core.camera import generate_rays
from ..core.film import Film
from ..core.rays import Rays
from ..core.vecmath import cross, dot, normalize, reflect, refract
from ..scene.device_scene import DeviceScene
from ..shade import materials as mats
from ..shade.sampling import cosine_sample_hemisphere, ggx_sample_half_vector
from ..shade.texture import sample_bilinear, sample_bundle
from . import launch_graph
from .intersect import (_use_qwalk, certain_or, mask_hole, scene_any,
                        scene_closest)

# Shadow / secondary-ray epsilons at Cornell scale, as in the JAX engine.
RAY_TMIN = 1e-2
SHADOW_TMAX_SCALE = 1.0 - 1e-3
# The BRDF and pdf scale by 1/pi, never divide by it: PyTorch's CUDA
# division by a Python scalar multiplies by its f32 reciprocal, the CPU's
# divides, so only a product rounds alike on both and in the fused kernel.
INV_PI = 1.0 / math.pi

IMPLS = ("auto", "fused", "wavefront", "spl")

# Rays per sample-major strip (engine.py:757-760): bounds the live wavefront
# state; a 1080p frame at 16 samples is 8 strips of 136 rows.
_SPL_TILE_RAYS = 4 * 1024 * 1024


def _pow5(x):
    """x**5 as XLA expands integer_pow: x * (x² · x²)."""
    x2 = x * x
    return x * (x2 * x2)


def _ggx_d(n_dh, rc):
    """The GGX normal distribution D(h) at n.h, roughness clamped."""
    a = rc * rc
    a2 = a * a
    denom = n_dh * n_dh * (a2 - 1.0) + 1.0
    return a2 / torch.clamp_min(math.pi * denom * denom, 1e-8)


def _pbr_brdf(n, wo, wi, albedo, metallic, roughness):
    """Metallic-roughness BRDF f(wo, wi) (engine.py:44-67): lambert *
    (1 - metal) + Smith-Schlick GGX, Schlick Fresnel with f0 = lerp(0.04,
    albedo, metal). Returns f [..., 3]."""
    h = normalize(wo + wi)
    n_dl = torch.clamp_min(dot(n, wi), 0.0)
    n_dv = torch.clamp_min(dot(n, wo), 1e-4)
    n_dh = torch.clamp_min(dot(n, h), 0.0)
    h_dv = torch.clamp_min(dot(h, wo), 0.0)
    rc = torch.clamp_min(roughness, 0.05)
    d_term = _ggx_d(n_dh, rc)
    k = (rc + 1.0) * (rc + 1.0) / 8.0
    g = (n_dv / (n_dv * (1 - k) + k)) * (n_dl / torch.clamp_min(
        n_dl * (1 - k) + k, 1e-8))
    f0 = 0.04 * (1.0 - metallic)[..., None] + metallic[..., None] * albedo
    fres = f0 + (1.0 - f0) * _pow5(1.0 - h_dv)[..., None]
    spec = fres * (d_term * g / torch.clamp_min(4.0 * n_dv * n_dl,
                                                1e-8))[..., None]
    diff = albedo * (1.0 - metallic)[..., None] * INV_PI
    return torch.where((n_dl > 0)[..., None], diff + spec, 0.0)


def _pbr_pdf(n, wo, wi, roughness, p_spec):
    """pdf of the cosine + GGX one-sample-MIS mixture that samples wi
    (engine.py:70-82)."""
    h = normalize(wo + wi)
    n_dl = torch.clamp_min(dot(n, wi), 0.0)
    n_dh = torch.clamp_min(dot(n, h), 0.0)
    h_dv = torch.clamp_min(dot(h, wo), 1e-6)
    pdf_ggx = (_ggx_d(n_dh, torch.clamp_min(roughness, 0.05)) * n_dh
               / torch.clamp_min(4.0 * h_dv, 1e-8))
    pdf_cos = n_dl * INV_PI
    return p_spec * pdf_ggx + (1.0 - p_spec) * pdf_cos


def _nee_direct_light(scene: DeviceScene, hit_p, n, throughput_albedo, rng,
                      chunk_size, mask=None, group_walk=False, pbr=None,
                      times=None):
    """Next-event estimation toward the parallelogram light: uniform point on
    the quad, weight nDl * LnDl * A / (pi d²) on the albedo-scaled throughput.
    With `pbr` (dict: albedo, metallic, roughness, wo, is_pbr, throughput)
    the PBR lanes take the full BRDF instead, T * f * Le * nDl * LnDl * A / d²
    (engine.py:135-142). On a volume scene both weights take the volume's
    transmittance toward the light, exp(-tau) (engine.py:122-129). times:
    the paths' shutter times. Returns (contribution [N, 3], rng)."""
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
                         group_walk=group_walk, times=times)
    lead = n_dl
    if scene.has_volume:
        tau_l = vol.optical_depth(scene.volume, hit_p, wi,
                                  torch.zeros_like(dist), dist,
                                  scene.volume_params[0])
        lead = torch.exp(-tau_l) * n_dl
    weight = torch.where(facing & ~occluded,
                         lead * ln_dl * light.area / (math.pi * dist2), 0.0)
    contrib = throughput_albedo * light.emission * weight[..., None]
    if pbr is not None:
        f = _pbr_brdf(n, pbr["wo"], wi, pbr["albedo"], pbr["metallic"],
                      pbr["roughness"])
        w2 = torch.where(facing & ~occluded,
                         lead * ln_dl * light.area / dist2, 0.0)
        contrib_pbr = pbr["throughput"] * f * light.emission * w2[..., None]
        contrib = torch.where(pbr["is_pbr"][..., None], contrib_pbr, contrib)
    return contrib, rng


def pixel_spread(cam_params, full_height: int):
    """The ray cone's spread angle per pixel for mip selection
    (engine.py:692-697, pallas_pt.py:1414-1416): 2|V| / (full_height x
    max(|W|, 1e-8)), a scalar tensor; the wavefront and the fused kernel
    take this one value."""
    v, w = cam_params["V"], cam_params["W"]
    return (2.0 * torch.sqrt(dot(v, v))
            / (full_height * torch.clamp_min(torch.sqrt(dot(w, w)), 1e-8)))


def _shading_normal(scene: DeviceScene, hits):
    """The normal the bounce shades with (engine.py:312-349) and the hit's
    shading frame (None where none is taken): the hit's geometric normal,
    or on a smooth or textured mesh the shading_frame epilogue's
    interpolated normal for triangle hits (custom prims keep their analytic
    normal; a flat textured mesh interpolates its replicated face normals,
    which rounds apart from the face normal, as the XLA engine does). The
    cluster walk interpolates smooth normals in its kernel, so no epilogue
    follows it on an untextured flat cluster scene. On an instanced scene
    the interpolated normal is in object space: with row ids, the hit
    instance's inverse goes back to world (tlas.world_shading_normal); without
    them the geometric normal stays. A scene with cutouts takes the
    epilogue always: its mask reads the frame's uv (engine.py:320-346)."""
    if not (scene.has_textures or scene.has_cutouts) and (
            not scene.geom.smooth or (scene.has_clusters
                                      and not scene.has_instances)):
        return hits.normal, None
    m = scene.num_triangles
    is_tri = hits.prim_id < m
    frame = shading_frame(scene.geom, torch.clamp(hits.prim_id, 0, m - 1),
                          hits.uv)
    sn = frame["shading_normal"]
    if not scene.has_instances:
        return torch.where(is_tri[..., None], sn, hits.normal), frame
    return world_shading_normal(scene.instances, hits, is_tri, sn), frame


def _texture_lanes(scene: DeviceScene, hits, hit_valid, frame, m, geom_n,
                   path_len, spread):
    """The texture block of the bounce (engine.py:350-402) on triangle hits:
    the bundle fetch at the uv of the shading frame, its mip level from the
    ray cone (spread x the path length to this hit, x the triangle's uv
    density); the base map's albedo factor, the metallic-roughness map
    scaling roughness (G) and metallic (B) in `m`, the emissive map scaling
    the emission in `m`, and the normal map in the tangent frame: t = tan -
    n (tan.n), divided by max(|t|, 1e-8), b = n x t, normalize(t nx + b ny
    + n nz). Returns (albedo factor [N, 3], the shading normal, the base
    map's alpha [N]: 1 where a lane has no base map)."""
    is_tri = hits.prim_id < scene.num_triangles
    cone = spread * (path_len + torch.where(hit_valid, hits.t, 0.0))
    texel_scale = torch.where(is_tri, cone * frame["uv_density"], 0.0)
    b16 = sample_bundle(scene.bundles, scene.bundle_mip,
                        torch.where(is_tri, m["bundle"], -1),
                        torch.where(is_tri[..., None], frame["uv"], hits.uv),
                        texel_scale=texel_scale)
    has_base = is_tri & (m["base_tex"] >= 0)
    albedo_tex = torch.where(has_base[..., None], b16[..., 0:3], 1.0)
    tex_alpha = torch.where(has_base, b16[..., 3], 1.0)
    has_mr = is_tri & (m["mr_tex"] >= 0)
    m["roughness"] = torch.where(has_mr, m["roughness"] * b16[..., 10],
                                 m["roughness"])
    m["metallic"] = torch.where(has_mr, m["metallic"] * b16[..., 11],
                                m["metallic"])
    has_em = is_tri & (m["emissive_tex"] >= 0)
    m["emission"] = torch.where(has_em[..., None],
                                m["emission"] * b16[..., 7:10], m["emission"])
    has_nm = is_tri & (m["normal_tex"] >= 0)
    nm = b16[..., 4:7] * 2.0 - 1.0
    tan = frame["tangent"]
    t_ = tan - geom_n * dot(tan, geom_n)[..., None]
    t_ = t_ / torch.clamp_min(torch.sqrt(dot(t_, t_)), 1e-8)[..., None]
    b_ = cross(geom_n, t_)
    n_mapped = normalize(t_ * nm[..., 0:1] + b_ * nm[..., 1:2]
                         + geom_n * nm[..., 2:3])
    return (albedo_tex, torch.where(has_nm[..., None], n_mapped, geom_n),
            tex_alpha)


def _cut_lanes(scene: DeviceScene, hits, hit_valid, m, surf_uv, tex_alpha):
    """The hits that land in a hole (engine.py:406-466) → bool [N]. With
    every summary certain, a triangle's summary alone decides (no mask is
    evaluated); else the mask at the surface uv (checker, circle, or the
    bundle fetch's base alpha against alpha_cutoff), overridden, where the
    scene has micromaps, by a certain summary and then by a certain
    micro-triangle state."""
    if scene.omm_all_certain:
        pid = torch.clamp(hits.prim_id, 0, scene.omm_summary.shape[0] - 1)
        hole = scene.omm_summary[pid.long()] == TRANSPARENT
    else:
        # without a base map the alpha reads 1 (engine.py:433-435)
        hole = mask_hole(m, surf_uv, tex_alpha if tex_alpha is not None
                         else torch.ones_like(hits.t))
        if scene.has_omm:
            pid = torch.clamp(hits.prim_id, 0,
                              scene.omm_summary.shape[0] - 1).long()
            summ = scene.omm_summary[pid]
            st = scene.omm_micro[pid, micro_index(
                hits.uv[..., 0], hits.uv[..., 1], scene.omm_level)]
            hole = certain_or(summ, certain_or(st, hole))
    return hit_valid & (m["alpha_mode"] == mats.ALPHA_MASK) & hole


def _volume_lanes(scene: DeviceScene, rays, hits, active, throughput,
                  radiance, rng, chunk_size, group_walk, times):
    """The participating medium along one segment (engine.py:253-294): a
    scatter point distance-sampled with pdf sigma_t T (the camera-side
    transmittance cancels), a point on the area light, a shadow query from
    the scatter point (kernel 2 on a brute-force scene) and the volume's
    transmittance toward the light; the in-scatter w albedo / (4 pi) Le
    LnDl A / d² exp(-tau_l) joins the radiance where the shadow ray is
    free, and the segment's transmittance exp(-tau) scales the throughput.
    The shadow rays are not counted in rays_traced (engine.py:585-587).
    Draws u_s, u_l1 and then u_l2 (the second value of that pair thrown
    away). → (throughput, radiance, rng)."""
    sigma_t = scene.volume_params[0]
    v_albedo = scene.volume_params[1]
    seg_far = torch.where(hits.valid, hits.t, rays.tmax)
    u_s, u_l1, rng = _rng.uniform2(rng)
    u_l2, _, rng = _rng.uniform2(rng)
    t_s, w_s, tau = vol.sample_scatter(scene.volume, rays.origin,
                                       rays.direction, rays.tmin, seg_far,
                                       sigma_t, u_s)
    light = scene.area_light
    p_s = rays.at(t_s)
    lp = light.corner + u_l1[..., None] * light.v1 + u_l2[..., None] * light.v2
    delta = lp - p_s
    dist2 = torch.clamp_min(dot(delta, delta), 1e-12)
    dist = torch.sqrt(dist2)
    wi_s = delta / dist[..., None]
    ln_dl = torch.abs(dot(light.normal.expand(wi_s.shape), wi_s))
    scatter_live = active & (w_s > 1e-6)
    occ_s = scene_any(scene, Rays(origin=p_s, direction=wi_s,
                                  tmin=torch.full_like(dist, RAY_TMIN),
                                  tmax=torch.where(scatter_live,
                                                   dist * SHADOW_TMAX_SCALE,
                                                   0.0)),
                      chunk_size=chunk_size, group_walk=group_walk,
                      times=times)
    tau_l = vol.optical_depth(scene.volume, p_s, wi_s, torch.zeros_like(dist),
                              dist, sigma_t)
    li = (light.emission * (ln_dl * light.area / dist2)[..., None]
          * torch.exp(-tau_l)[..., None])
    # a true division by 4 pi on every device (a CUDA division by a Python
    # scalar multiplies by its f32 reciprocal)
    four_pi = torch.full((), 4.0 * math.pi, dtype=torch.float32,
                         device=w_s.device)
    inscatter = (w_s * v_albedo / four_pi)[..., None] * li
    radiance = radiance + torch.where((scatter_live & ~occ_s)[..., None],
                                      throughput * inscatter, 0.0)
    return throughput * torch.exp(-tau)[..., None], radiance, rng


def _bounce(scene: DeviceScene, state: dict, depth: int, chunk_size,
            exact: bool = False, group_walk: bool = False,
            spread=0.0) -> dict:
    """One bounce of the whole wavefront (engine.py:241-611): closest hit,
    the volume lanes on a volume scene (`_volume_lanes`), miss and emission
    terms, the texture lanes (`spread`: pixel_spread), the cut lanes, the
    material lanes (glass, mirror, PBR, diffuse), NEE on the diffuse and PBR
    lanes, the next direction and throughput, Russian roulette. A cut lane
    keeps its direction, throughput and previous-specular flag, moves its
    origin RAY_TMIN along d past the hit, survives roulette (q = 1) and
    traces no shadow ray; it is neither a hit nor ended. Every query takes
    the paths' shutter times (state["time"], on a motion scene). Returns
    the next state."""
    rays = state["rays"]
    active = state["active"]
    throughput = state["throughput"]
    radiance = state["radiance"]
    rng = state["rng"]
    times = state.get("time")

    hits = scene_closest(scene, rays, chunk_size=chunk_size, exact=exact,
                         group_walk=group_walk, times=times)
    hit_valid = hits.valid & active
    if scene.has_volume:
        throughput, radiance, rng = _volume_lanes(
            scene, rays, hits, active, throughput, radiance, rng, chunk_size,
            group_walk, times)

    # miss program: constant background
    radiance = radiance + torch.where((active & ~hits.valid)[..., None],
                                      throughput * scene.miss_color, 0.0)

    cutouts = scene.has_cutouts
    m = mats.gather(scene.materials, hits.mat_id,
                    mats.PT_FIELDS + mats.CUT_FIELDS if cutouts
                    else mats.PT_FIELDS)
    d = rays.direction
    geom_n, frame = _shading_normal(scene, hits)
    albedo = m["base_color"]
    tex_alpha = None
    if scene.has_textures:
        albedo_tex, geom_n, tex_alpha = _texture_lanes(
            scene, hits, hit_valid, frame, m, geom_n, state["path_len"],
            spread)
        albedo = albedo * albedo_tex
    # two-sided shading normal, faceforward(N, -D, N)
    n = geom_n * torch.sign(-dot(geom_n, d))[..., None]
    hit_p = rays.at(hits.t)

    if cutouts:
        # the mask reads the shading frame's uv on triangle hits, a prim
        # hit's own uv
        is_tri = hits.prim_id < scene.num_triangles
        surf_uv = torch.where(is_tri[..., None], frame["uv"], hits.uv)
        is_cut = _cut_lanes(scene, hits, hit_valid, m, surf_uv, tex_alpha)
        hit_valid = hit_valid & ~is_cut

    # Emission only on primary hits or after a specular bounce: NEE covers
    # the rest.
    take_emission = hit_valid & state["prev_specular"]
    radiance = radiance + torch.where(take_emission[..., None],
                                      throughput * m["emission"], 0.0)

    kind = m["kind"]
    is_glass = kind == mats.GLASS
    # a perfect mirror is fully metallic AND polished; other PBR takes GGX
    is_mirror = ((kind == mats.PBR) & (m["metallic"] > 0.99)
                 & (m["roughness"] <= 0.05))
    is_pbr = (kind == mats.PBR) & ~is_mirror
    is_specular = is_glass | is_mirror
    is_diffuse = ~is_specular

    # NEE on the diffuse lanes (PBR lanes with the full BRDF)
    t_albedo = throughput * albedo
    nee_mask = hit_valid & is_diffuse
    contrib, rng = _nee_direct_light(
        scene, hit_p, n, t_albedo, rng, chunk_size, mask=nee_mask,
        group_walk=group_walk, times=times,
        pbr=(dict(albedo=albedo, metallic=m["metallic"],
                  roughness=m["roughness"], wo=-d, is_pbr=is_pbr,
                  throughput=throughput) if scene.has_pbr else None))
    radiance = radiance + torch.where(nee_mask[..., None], contrib, 0.0)

    u1, u2, rng = _rng.uniform2(rng)
    new_dir = cosine_sample_hemisphere(u1, u2, n)
    new_throughput = t_albedo        # diffuse: f * cos / pdf = albedo

    if scene.has_pbr:
        # one-sample MIS between the cosine and GGX lobes
        rough = torch.clamp_min(m["roughness"], 0.05)
        metal = m["metallic"]
        u5p, u6p, rng = _rng.uniform2(rng)
        h_vec = ggx_sample_half_vector(u5p, u6p, n, rough)
        d_ggx = normalize(reflect(d, h_vec))
        p_spec = torch.clamp(0.5 * metal + 0.1, 0.05, 0.95)
        u7p, _, rng = _rng.uniform2(rng)
        d_pbr = torch.where((u7p < p_spec)[..., None], d_ggx, new_dir)
        f_pbr = _pbr_brdf(n, -d, d_pbr, albedo, metal, rough)
        pdf_pbr = _pbr_pdf(n, -d, d_pbr, rough, p_spec)
        n_dl_pbr = torch.clamp_min(dot(n, d_pbr), 0.0)
        valid_dir = (n_dl_pbr > 1e-5) & (pdf_pbr > 1e-7)
        w_pbr = torch.where(
            valid_dir[..., None],
            f_pbr * (n_dl_pbr / torch.clamp_min(pdf_pbr, 1e-7))[..., None],
            0.0)
        new_dir = torch.where(is_pbr[..., None], d_pbr, new_dir)
        new_throughput = torch.where(is_pbr[..., None], throughput * w_pbr,
                                     new_throughput)

    u3, _, rng = _rng.uniform2(rng)     # the glass pair (engine.py:536)
    if scene.specular_lanes:
        # mirror reflection; glass picks reflect / refract by Schlick Fresnel
        d_mirror = normalize(reflect(d, n))
        ior = m["ior"]
        eta = torch.where(dot(d, geom_n) < 0.0, 1.0 / ior, ior)
        d_refr, refr_ok = refract(d, n, eta)
        cos_i = torch.clamp(-dot(d, n), 0.0, 1.0)
        r = (ior - 1.0) / (ior + 1.0)
        r0 = r * r
        fresnel = r0 + (1.0 - r0) * _pow5(1.0 - cos_i)
        glass_reflect = (~refr_ok) | (u3 < fresnel)
        d_glass = torch.where(glass_reflect[..., None], d_mirror,
                              normalize(d_refr))
        new_dir = torch.where(is_glass[..., None], d_glass,
                              torch.where(is_mirror[..., None], d_mirror,
                                          new_dir))
        spec_tint = torch.where((m["kr"] > 0.0).any(dim=-1, keepdim=True),
                                m["kr"], albedo)
        new_throughput = torch.where(is_specular[..., None],
                                     throughput * spec_tint, new_throughput)

    if cutouts:
        # a cut lane passes straight through
        new_dir = torch.where(is_cut[..., None], d, new_dir)
        new_throughput = torch.where(is_cut[..., None], throughput,
                                     new_throughput)
    offset_n = torch.where(dot(new_dir, n)[..., None] >= 0.0, n, -n)
    if cutouts:
        offset_n = torch.where(is_cut[..., None], d, offset_n)
    new_origin = hit_p + offset_n * RAY_TMIN

    # Russian roulette after depth 1 (never on a cut lane)
    u5, _, rng = _rng.uniform2(rng)
    q = torch.clamp(new_throughput.amax(dim=-1), 0.05, 1.0)
    if cutouts:
        q = torch.where(is_cut, 1.0, q)
    if depth >= 1:
        survive = (u5 < q) | is_cut if cutouts else u5 < q
        new_throughput = new_throughput / q[..., None]
    else:
        survive = torch.ones_like(active)

    # closest-hit rays of live lanes and NEE shadow rays; the volume's
    # scatter shadow rays are not counted, as in the reference
    rays_traced = state["rays_traced"] + active.sum() + nee_mask.sum()
    prev_specular = is_specular
    if cutouts:
        active = (hit_valid | is_cut) & survive
        prev_specular = torch.where(is_cut, state["prev_specular"],
                                    is_specular)
    else:
        active = hit_valid & survive
    out = dict(state)
    out.update(
        # Dead lanes get an empty ray window: the cluster cull drops whole
        # blocks of them.
        rays=Rays(origin=new_origin, direction=new_dir,
                  tmin=torch.full_like(hits.t, RAY_TMIN),
                  tmax=torch.where(active, 1e16, 0.0)),
        throughput=new_throughput, radiance=radiance, rng=rng,
        active=active, prev_specular=prev_specular,
        path_len=state["path_len"] + torch.where(hit_valid, hits.t, 0.0),
        rays_traced=rays_traced)
    return out


def _sort_wavefront(scene: DeviceScene, state: dict) -> dict:
    """Coherence-sort the whole path state for the next bounce
    (engine.py:146-189): one stable sort by `coherence_key`, every per-ray
    column permuted alike; dead rays go to the tail. The `engine.sort`
    span."""
    with telemetry.span("engine.sort"):
        rays = state["rays"]
        perm = torch.argsort(coherence_key(scene.clusters, rays), stable=True)
        out = {k: (v[perm] if v.ndim else v)
               for k, v in state.items() if k != "rays"}
        out["rays"] = Rays(origin=rays.origin[perm],
                           direction=rays.direction[perm],
                           tmin=rays.tmin[perm], tmax=rays.tmax[perm])
        return out


def trace_paths(scene: DeviceScene, rays: Rays, rng, max_depth: int = 4,
                chunk_size: Optional[int] = 65536, sample_major: bool = False,
                active0=None, group_walk: Optional[bool] = None,
                spread=0.0):
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
    (it never changes a hit, only the work); unset, the sample-major path
    reads ORT_GROUP_WALK (0 turns gating off, engine.py:622-628).
    active0 marks lanes that are live on arrival (strip padding is not).
    spread (pixel_spread's value) sets the textured mip level. On a motion
    scene each path first draws its shutter time (engine.py:212-217), which
    rides in the state (sorted with it) to every query.
    """
    scene.require_supported()
    n_rays = rays.tmin.shape[0]
    dev = rays.origin.device
    path_time = None
    if scene.has_motion:
        path_time, _, rng = _rng.uniform2(rng)
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
        # the path length to the last hit: the ray cone's width is the
        # spread times it (engine.py:233-235)
        path_len=torch.zeros((n_rays,), dtype=torch.float32, device=dev),
        rays_traced=torch.zeros((), dtype=torch.int64, device=dev))
    if path_time is not None:
        state["time"] = path_time

    if scene.has_clusters and sample_major:
        gw = (os.environ.get("ORT_GROUP_WALK", "1") != "0"
              if group_walk is None else group_walk)
        state = _bounce(scene, state, 0, chunk_size, group_walk=gw,
                        spread=spread)
        for depth in range(1, max_depth):
            state = _bounce(scene, state, depth, chunk_size, exact=True,
                            group_walk=gw, spread=spread)
    elif scene.has_clusters:
        gw = bool(group_walk)
        state["pix"] = torch.arange(n_rays, device=dev)
        state = _bounce(scene, state, 0, chunk_size, group_walk=gw,
                        spread=spread)
        for depth in range(1, max_depth):
            state = _bounce(scene, _sort_wavefront(scene, state), depth,
                            chunk_size, exact=True, group_walk=gw,
                            spread=spread)
        pix = state["pix"]
        for key in ("radiance", "rng"):
            back = torch.empty_like(state[key])
            back[pix] = state[key]
            state[key] = back
    else:
        for depth in range(max_depth):
            state = _bounce(scene, state, depth, chunk_size, spread=spread)
    return state["radiance"], state["rng"], state["rays_traced"]


def render_sample(scene: DeviceScene, cam_params, width: int, height: int,
                  subframe, max_depth: int = 4,
                  chunk_size: Optional[int] = 65536,
                  y0=0, full_width=None, full_height=None, y_stride=1,
                  group_walk=None):
    """One progressive sample of a [height, width] row tile → (radiance
    [H, W, 3], rays_traced). The RNG is seeded from the global pixel index
    (row gy = i * y_stride + y0, engine.py:665-689) and `subframe` (an int
    or an integer tensor on the device), so a tiled frame draws the
    single-process frame's paths. group_walk: trace_paths'."""
    dev = scene.device
    n = width * height
    full_w = width if full_width is None else full_width
    gy = (torch.arange(height, dtype=torch.int64, device=dev)[:, None]
          * y_stride + y0)
    gx = torch.arange(width, dtype=torch.int64, device=dev)[None, :]
    pixel_idx = (gy * full_w + gx).reshape(n)
    if isinstance(subframe, torch.Tensor):
        subframe = subframe.to(dev)
    rng = _rng.seed(pixel_idx, subframe)
    rays, rng = generate_rays(cam_params, width, height,
                              rng_state=rng.reshape(height, width), y0=y0,
                              full_width=full_width, full_height=full_height,
                              y_stride=y_stride)
    full_h = height if full_height is None else full_height
    radiance, _, rays_traced = trace_paths(
        scene, rays.reshape(n), rng.reshape(n), max_depth=max_depth,
        chunk_size=chunk_size, group_walk=group_walk,
        spread=pixel_spread(cam_params, full_h))
    return radiance.reshape(height, width, 3), rays_traced


def render_sample_group(scene: DeviceScene, cam_params, width: int,
                        height: int, subframe, spl: int, max_depth: int = 4,
                        chunk_size: Optional[int] = 65536, y0=0,
                        full_width=None, full_height=None, group_walk=None):
    """`spl` progressive samples of a [height, width] tile traced as one
    sample-major wavefront (engine.py:706-754) → (radiance SUM [H, W, 3],
    rays_traced). Lane p*spl + s is sample s of pixel p, seeded
    seed(pixel_idx, subframe + s): the streams of the sequential loop.
    Rows past `full_height` (strip padding) are dead on arrival.
    group_walk: trace_paths'."""
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
        chunk_size=chunk_size, sample_major=True, active0=in_frame,
        group_walk=group_walk, spread=pixel_spread(cam_params, full_h))
    return radiance.reshape(height, width, spl, 3).sum(dim=2), rays_traced


def _use_fused(scene: DeviceScene, impl: str) -> bool:
    """`engine.py:772-821` minus its TPU test: the fused kernel on a CUDA
    device for a scene of at most MAX_FUSED_TRIS triangles and
    MAX_FUSED_MATS materials, at most MAX_FUSED_PRIMS custom prims of
    FUSED_PRIM_KINDS, no feature but glass, mirror and pbr, and, on an
    instanced scene, at most MAX_FUSED_INST instances whose ranges sum to
    at most MAX_FUSED_TRIS triangles of flat-shaded meshes (the kernel's
    instance variant has no shading-frame epilogue). A textured scene takes
    it with a texture bundle and without instances. The reference keeps
    its texture unit opt-in (ORT_FUSED_TEX, engine.py:785-802) because it
    was slower than XLA on the TPU; on the H100 the texture instantiation
    is bit-equal to the wavefront's texture lanes and far faster, so no
    option is needed, and its table-size cap is a TPU VMEM budget (the
    port's atlas stays in device memory). Motion and volume scenes never
    take it (engine.py:819-820). Decided by the scene alone: its content
    once (DeviceScene.fused_fits, `_fused_fits`), its device every call."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl != "auto":
        return impl == "fused"
    return scene.device.type == "cuda" and scene.fused_fits


def _fused_fits(scene: DeviceScene) -> bool:
    """`_use_fused`'s rule for "auto" without the device test."""
    from .pallas_pt import (FUSED_FEATURES, FUSED_PRIM_KINDS, MAX_FUSED_INST,
                            MAX_FUSED_MATS, MAX_FUSED_PRIMS, MAX_FUSED_TRIS,
                            fused_inst_ranges)
    prims_ok = (scene.prims.num <= MAX_FUSED_PRIMS
                and all(k in FUSED_PRIM_KINDS
                        for k in scene.prims.kinds_static))
    if scene.has_textures and (scene.bundles.shape[0] == 0
                               or scene.has_instances):
        return False
    ranges = fused_inst_ranges(scene)
    inst_ok = not scene.has_instances or (
        len(ranges) <= MAX_FUSED_INST
        and sum(hi - lo for lo, hi in ranges) <= MAX_FUSED_TRIS
        and not scene.geom.smooth)
    return (prims_ok
            and inst_ok
            and not scene.has_motion
            and not scene.has_volume
            and set(scene.features) <= FUSED_FEATURES
            and scene.num_triangles <= MAX_FUSED_TRIS
            and scene.materials.num <= MAX_FUSED_MATS)


def _merge_launch(film: Film, rad_sum, samples_per_launch: int) -> Film:
    """Merge one launch's radiance SUM into the film: progressive mean plus
    one variance-tracker estimate per launch, the same for both paths (the
    `engine.merge` span)."""
    with telemetry.span("engine.merge"):
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


def _spl_major_default() -> bool:
    """Whether "auto" takes the sample-major path on a cluster scene: on
    unless ORT_SPL_MAJOR is set to anything but 1 (engine.py:763-769), read
    at call time. Either path gives the same estimator and rays."""
    return os.environ.get("ORT_SPL_MAJOR", "1") == "1"


def render_accumulate(scene: DeviceScene, cam_params, film: Film, width: int,
                      height: int, samples_per_launch: int = 1,
                      max_depth: int = 4,
                      chunk_size: Optional[int] = 65536,
                      y0=0, full_width=None, full_height=None,
                      impl: str = "auto", group_walk=None):
    """Add `samples_per_launch` samples to the film → (film, rays_traced).

    impl: "fused" runs the fused path-trace kernel (kernel 3 and its
    specular / PBR / prim / instance / smooth-normal instantiations, 3';
    its plain version on the CPU); "wavefront" the lock-step engine one
    sample after another (on CUDA its intersections come from kernels 1-2,
    or kernels 4-6 on a cluster scene); "spl" the sample-major engine in
    strips of
    about _SPL_TILE_RAYS rays (render_sample_group); "auto" the fused
    kernel where `_use_fused` allows it, else "spl" on a cluster scene with
    at least 8 samples per launch unless ORT_SPL_MAJOR=0
    (`_spl_major_default`), else "wavefront". All consume identical
    RNG streams. On a cluster scene the walk's group gating is on for
    "spl" and off for "wavefront" (trace_paths); group_walk=True or False
    sets it on both (engine.py:846-852). Gating changes only the work,
    never a hit. The call is the `engine.render_accumulate` span, the root
    of one launch's spans (telemetry.launch).
    """
    with telemetry.launch("engine.render_accumulate"):
        rad_sum, rays = render_sum(
            scene, cam_params, width, height, film.subframe,
            samples_per_launch, max_depth=max_depth, chunk_size=chunk_size,
            y0=y0, full_width=full_width, full_height=full_height,
            impl=impl, group_walk=group_walk)
        return _merge_launch(film, rad_sum, samples_per_launch), rays


def render_sum(scene: DeviceScene, cam_params, width: int, height: int,
               subframe, samples_per_launch: int, max_depth: int = 4,
               chunk_size: Optional[int] = 65536, y0=0, full_width=None,
               full_height=None, impl: str = "auto", group_walk=None):
    """One launch's radiance SUM [H, W, 3] over `samples_per_launch`
    samples from `subframe`, and its rays_traced, by render_accumulate's
    `impl` rule; render_accumulate merges it into the film. The pipeline's
    validation counters read this sum, not one recovered from the films."""
    if _use_fused(scene, impl):
        from . import pallas_pt
        return pallas_pt.render_sum_fused(
            scene, cam_params, width, height, subframe,
            samples_per_launch=samples_per_launch, max_depth=max_depth,
            y0=y0, full_width=full_width, full_height=full_height)
    if impl == "spl" or (impl == "auto" and scene.has_clusters
                         and samples_per_launch >= 8
                         and _spl_major_default()):
        return render_sum_sample_major(
            scene, cam_params, width, height, subframe,
            samples_per_launch, max_depth=max_depth, chunk_size=chunk_size,
            y0=y0, full_width=full_width, full_height=full_height,
            group_walk=group_walk)
    return render_sum_wavefront(
        scene, cam_params, width, height, subframe,
        samples_per_launch, max_depth=max_depth, chunk_size=chunk_size,
        y0=y0, full_width=full_width, full_height=full_height,
        group_walk=group_walk)


def render_sum_sample_major(scene: DeviceScene, cam_params, width: int,
                            height: int, subframe, samples_per_launch: int,
                            max_depth: int = 4,
                            chunk_size: Optional[int] = 65536, y0=0,
                            full_width=None, full_height=None,
                            group_walk=None):
    """`samples_per_launch` samples as sample-major strips of `rows` rows,
    each about _SPL_TILE_RAYS rays (engine.py:872-904) → (radiance SUM
    [H, W, 3], rays_traced). group_walk: trace_paths'. Each strip is an
    `engine.strip` span; on a cluster scene the launch counts in
    `clusters.queries`."""
    with telemetry.span("engine.render_sum_sample_major"):
        if scene.has_clusters:
            CLUSTER_QUERIES["launches"] += 1
        rows = min(height, max(1, _SPL_TILE_RAYS
                               // max(width * samples_per_launch, 1)))
        n_strips = -(-height // rows)
        rad_sum = torch.zeros((n_strips * rows, width, 3),
                              dtype=torch.float32, device=scene.device)
        count = torch.zeros((), dtype=torch.int64, device=scene.device)
        for i in range(n_strips):
            with telemetry.span("engine.strip"):
                r, c = render_sample_group(
                    scene, cam_params, width, rows, subframe,
                    samples_per_launch, max_depth=max_depth,
                    chunk_size=chunk_size, y0=y0 + i * rows,
                    full_width=width if full_width is None else full_width,
                    full_height=(height if full_height is None
                                 else full_height),
                    group_walk=group_walk)
                rad_sum[i * rows:(i + 1) * rows] = r
                count = count + c
        return rad_sum[:height], count


def render_sum_wavefront(scene: DeviceScene, cam_params, width: int,
                         height: int, subframe, samples_per_launch: int,
                         max_depth: int = 4,
                         chunk_size: Optional[int] = 65536,
                         y0=0, full_width=None, full_height=None,
                         group_walk=None):
    """`samples_per_launch` sequential `render_sample`s from `subframe` →
    (radiance SUM [H, W, 3], rays_traced). group_walk: trace_paths'. On a
    cluster scene the launch counts in `clusters.queries`, and on the card
    it is captured as one CUDA graph after a launch of its shape that made
    no sync, and replayed (`launch_graph`)."""
    def launch(cam, sub):
        rad_sum = torch.zeros((height, width, 3), dtype=torch.float32,
                              device=scene.device)
        count = torch.zeros((), dtype=torch.int64, device=scene.device)
        for i in range(samples_per_launch):
            radiance, rays_traced = render_sample(
                scene, cam, width, height, sub + i,
                max_depth=max_depth, chunk_size=chunk_size, y0=y0,
                full_width=full_width, full_height=full_height,
                group_walk=group_walk)
            rad_sum = rad_sum + radiance
            count = count + rays_traced
        return rad_sum, count

    with telemetry.span("engine.render_sum_wavefront"):
        if scene.has_clusters:
            CLUSTER_QUERIES["launches"] += 1
            if launch_graph.usable(scene, cam_params, subframe):
                key = (width, height, samples_per_launch, max_depth,
                       chunk_size, y0, full_width, full_height, group_walk,
                       _use_qwalk(),
                       tuple((k, v.shape, v.dtype)
                             for k, v in cam_params.items()))
                return launch_graph.run(scene, key, launch, cam_params,
                                        subframe)
        return launch(cam_params, subframe)


def render_aovs(scene: DeviceScene, cam_params, width: int, height: int,
                chunk_size: Optional[int] = 65536):
    """Primary-hit guide layers for the denoiser (engine.py:923-967): one
    centred, unjittered camera ray a pixel through `scene_closest` (kernel
    1 on a CUDA brute-force scene). albedo: the material's base colour,
    times the base map's `sample_bilinear` at the shading frame's uv on a
    textured scene; normal: the hit's normal, the shading frame's on a
    smooth scene without instances; emission: the material's, the
    engine's depth-0 emission term. A miss gives albedo 1, normal
    -direction and emission 0. (The reference also fetches the base map
    on a miss of a textured scene, at the barycentrics its brute force
    leaves in a missed ray's record, and scales the miss's 1 by it; the
    port reads no texel there.) → {"albedo", "normal", "emission"}, each
    [H, W, 3]."""
    rays, _ = generate_rays(cam_params, width, height, jitter=False)
    n = width * height
    rays = rays.reshape(n)
    hits = scene_closest(scene, rays, chunk_size=chunk_size)
    m = mats.gather(scene.materials, hits.mat_id,
                    fields=("base_color", "emission", "base_tex"))
    valid = hits.valid[:, None]
    albedo = torch.where(valid, m["base_color"], 1.0)
    if scene.has_textures or (scene.geom.smooth and not scene.has_instances):
        is_tri = hits.prim_id < scene.num_triangles
        frame = shading_frame(scene.geom, torch.clamp(
            hits.prim_id, 0, scene.num_triangles - 1), hits.uv)
    if scene.has_textures:
        rgba = sample_bilinear(scene.textures, scene.tex_size,
                               torch.where(is_tri & hits.valid,
                                           m["base_tex"], -1),
                               frame["uv"])
        albedo = albedo * rgba[..., :3]
    normal = hits.normal
    if scene.geom.smooth and not scene.has_instances:
        normal = torch.where(is_tri[:, None], frame["shading_normal"],
                             normal)
    normal = torch.where(valid, normal, -rays.direction)
    emission = torch.where(valid, m["emission"], 0.0)
    return {"albedo": albedo.reshape(height, width, 3),
            "normal": normal.reshape(height, width, 3),
            "emission": emission.reshape(height, width, 3)}
