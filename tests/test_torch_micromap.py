"""The port's opacity micromaps and what they need (accel/micromap.py, the
texture atlas and sample_bilinear, the micromap split of the DeviceScene,
the alpha occlusion paths of wavefront/intersect.py) against the JAX
package on the CPU.

Bars: the micromap states and summaries, micro_index, the split's row ids
and sizes and the occlusion answers equal; displace_mesh, pack_textures'
atlas and sample_bilinear within 1e-6. The occlusion sets are bench.py's
shadow-ray distribution (bench.py:490-497, 565-570), 4,096 rays a scene,
on the scenes of bench.py's cutout cells: the cutout Cornell, the
opaque-alpha Cornell, the cutout grid (a cluster scene), the textured
cutout Cornell, and the cutout Cornell without micromaps. The port's scene
is the JAX scene handed over (torch_parity.scene_fields: geometry, atlas,
material planes, micromap states; the port derives the split), so both
sides test the same bits. The JAX queries run under jax.disable_jit: XLA
contracts a*b+c into FMAs inside jit, which moves t, uv and the mask's
inputs by an ulp; eagerly they round as the port does, and no tolerance is
needed. About 40 s on one worker.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_raytracer_tpu.accel import micromap as jmm
from optix_raytracer_tpu.apps import displaced_micromesh as jdmm
from optix_raytracer_tpu.core.rays import Rays as JRays
from optix_raytracer_tpu.scene import device_scene as jds
from optix_raytracer_tpu.shade import materials as jmats
from optix_raytracer_tpu.shade.lights import ParallelogramLight as JLight
from optix_raytracer_tpu.shade.texture import sample_bilinear as jsample
from optix_raytracer_tpu.wavefront import intersect as jix
from optix_raytracer_tpu_torch.accel import micromap as tmm
from optix_raytracer_tpu_torch.apps import displaced_micromesh as tdmm
from optix_raytracer_tpu_torch.core.rays import Rays
from optix_raytracer_tpu_torch.scene import builtins as tb
from optix_raytracer_tpu_torch.scene import device_scene as tds
from optix_raytracer_tpu_torch.shade import materials as tmats
from optix_raytracer_tpu_torch.shade.texture import sample_bilinear
from optix_raytracer_tpu_torch.wavefront import intersect as tix

from torch_parity import one_torch_thread, scene_fields  # noqa: F401

PARTS = {"cutout_cornell": tb.cutout_cornell_parts,
         "opaque_alpha": tb.opaque_alpha_cornell_parts,
         "cutout_grid": tb.cutout_grid_parts,
         "textured_cutout": tb.textured_cutout_cornell_parts,
         "no_omm": tb.cutout_cornell_parts}


def jax_scene(parts, **kw):
    """The JAX package's scene of a builtins *_parts() tuple."""
    verts, idx, tri_mat, materials, uvs, textures, light = parts
    if light is not None:
        kw["area_light"] = JLight.make(*light)
    return jds.make_device_scene(verts, idx, tri_mat, materials, uvs=uvs,
                                 textures=textures, **kw)


@pytest.fixture(scope="module")
def scenes():
    """name → (JAX scene, the port's own build, the JAX scene handed
    over)."""
    out = {}
    for name, parts in PARTS.items():
        kw = {"opacity_micromaps": False} if name == "no_omm" else {}
        js = jax_scene(parts(), **kw)
        out[name] = (js, tb.scene_from_parts(parts(), "cpu", **kw),
                     tds.device_scene_from_numpy(scene_fields(js), "cpu"))
    return out


def shadow_rays(name, n=4096, seed=3):
    """bench.py's occlusion rays: origins uniform in [50, 500]³ (the grid:
    [50, 450] x [50, 250] x [50, 450], below its plane), unit directions,
    tmin 1e-2, tmax 1e4 → (port Rays, JAX Rays)."""
    rng = np.random.default_rng(seed)
    hi = [450, 250, 450] if name == "cutout_grid" else [500, 500, 500]
    o = rng.uniform([50, 50, 50], hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(n, 1e-2, np.float32)
    tmax = np.full(n, 1e4, np.float32)
    return (Rays(*(torch.as_tensor(a) for a in (o, d, tmin, tmax))),
            JRays(origin=jnp.asarray(o), direction=jnp.asarray(d),
                  tmin=jnp.asarray(tmin), tmax=jnp.asarray(tmax)))


@pytest.mark.parametrize("mask,level", [("checker", 2), ("checker", 3),
                                        ("circle", 2), ("circle", 3)])
def test_build_opacity_micromap_matches_jax(mask, level):
    """States and summary (uint8) equal on random corner uvs, each
    package's mask function at scales 1, 3 and 4."""
    rng = np.random.default_rng(level + 7 * (mask == "circle"))
    corner_uv = rng.uniform(-2, 3, (64, 3, 2)).astype(np.float32)
    corner_uv[:8] *= 0.1                       # small: certain summaries
    for scale in (1.0, 3.0, 4.0):
        st, su = tmm.build_opacity_micromap(
            corner_uv, getattr(tmm, f"{mask}_mask")(scale), level=level)
        jst, jsu = jmm.build_opacity_micromap(
            corner_uv, getattr(jmm, f"{mask}_mask")(scale), level=level)
        assert st.dtype == su.dtype == np.uint8
        np.testing.assert_array_equal(st, jst)
        np.testing.assert_array_equal(su, jsu)
        assert (su == tmm.UNKNOWN_OPAQUE).any()


def test_scene_omm_texture_mask_matches_jax():
    """build_scene_omm against the reference's _build_scene_omm on random
    corner uvs: checker, circle, a CUT_TEXTURE material on a float RGBA map
    and on a uint8 one (the nearest texel, wrapped), one on an RGB map (no
    alpha: never a hole), a mask material with no mask function and a
    material that is no cutout."""
    rng = np.random.default_rng(5)
    m = 7
    tri_mat = np.repeat(np.arange(m, dtype=np.int32), 24)
    corner_uv = rng.uniform(-1.5, 2.5, (len(tri_mat), 3, 2)).astype(
        np.float32)
    corner_uv[::3] = rng.uniform(0.3, 0.32, (len(tri_mat[::3]), 3, 2))
    rgba = rng.uniform(0, 1, (13, 9, 4)).astype(np.float32)
    textures = [rgba, tb.alpha_map(16), rng.integers(
        0, 255, (4, 4, 3)).astype(np.uint8)]
    mask = dict(alpha_mode=tmats.ALPHA_MASK)
    materials = [
        dict(mask, cutout=tmats.CUT_CHECKER, checker_scale=3.0),
        dict(mask, cutout=tmats.CUT_CIRCLE, checker_scale=2.0),
        dict(mask, cutout=tmats.CUT_TEXTURE, base_tex=0, alpha_cutoff=0.4),
        dict(mask, cutout=tmats.CUT_TEXTURE, base_tex=1),
        dict(mask, cutout=tmats.CUT_TEXTURE, base_tex=2),
        dict(mask, cutout=tmats.CUT_TEXTURE),
        dict(kind=tmats.DIFFUSE)]
    for level in (1, 3):
        st, su = tds.build_scene_omm(materials, tri_mat, corner_uv, textures,
                                     level)
        jst, jsu = jds._build_scene_omm(materials, tri_mat, corner_uv,
                                        textures, level)
        np.testing.assert_array_equal(st, jst)
        np.testing.assert_array_equal(su, jsu)
        assert set(np.unique(su)) == {tmm.TRANSPARENT, tmm.OPAQUE,
                                      tmm.UNKNOWN_OPAQUE}


@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_micro_index_matches_jax(level):
    """micro_index equal (and each centroid's own index) on random
    barycentrics and on edge ones: 0, 1, the lattice lines k/n and an ulp
    either side, the clip 1 - 1e-7 and its neighbours, a little outside
    [0, 1], and pairs on u + v = 1 and an ulp inside or outside it (the
    inverted test)."""
    n = 1 << level
    cents = tmm._micro_corners(level).mean(axis=1)
    np.testing.assert_array_equal(
        tmm.micro_index(torch.as_tensor(cents[:, 0]),
                        torch.as_tensor(cents[:, 1]), level).numpy(),
        np.arange(4 ** level))
    rng = np.random.default_rng(level)
    f = np.float32
    lines = np.arange(n + 1, dtype=f) / f(n)
    edge = np.concatenate([
        lines, np.nextafter(lines, f(-1)), np.nextafter(lines, f(2)),
        f([1 - 1e-7, 0.99999994, 0.9999999, 1.0000001, -1e-7, -0.5, 1.5])])
    u = np.concatenate([rng.uniform(0, 1, 4096).astype(f),
                        np.repeat(edge, len(edge)), edge, edge, edge])
    v = np.concatenate([rng.uniform(0, 1, 4096).astype(f),
                        np.tile(edge, len(edge)), f(1) - edge,
                        np.nextafter(f(1) - edge, f(-1)),
                        np.nextafter(f(1) - edge, f(2))])
    out = tmm.micro_index(torch.as_tensor(u), torch.as_tensor(v), level)
    ref = jmm.micro_index(jnp.asarray(u), jnp.asarray(v), level)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert int(out.min()) >= 0 and int(out.max()) < 4 ** level


def test_displace_mesh_matches_jax():
    """The micromesh app's plane at levels 1-4, and a random mesh with the
    default (area-weighted normal) directions and a constant amount, within
    1e-6; indices equal."""
    for level in (1, 2, 3, 4):
        v, i = tdmm.make_displaced_plane(level)
        jv, ji = jdmm.make_displaced_plane(level)
        np.testing.assert_allclose(v, jv, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(i, ji)
        assert i.shape == (2 * 4 ** level, 3)
    rng = np.random.default_rng(2)
    verts = rng.uniform(-1, 1, (12, 3)).astype(np.float32)
    idx = rng.integers(0, 12, (9, 3)).astype(np.int32)
    for amount in (0.3, lambda p, b: p[:, 0] * b[:, 1]):
        v, i = tmm.displace_mesh(verts, idx, amount, level=2)
        jv, ji = jmm.displace_mesh(verts, idx, amount, level=2)
        np.testing.assert_allclose(v, jv, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(i, ji)


@pytest.mark.parametrize("name", list(PARTS))
def test_omm_split_matches_jax(scenes, name):
    """The port's own build against the JAX package's: the feature tags,
    the micro states, the summary, the unknown row ids, the split sizes and
    whether the solid split has a cluster table; the handed-over scene's
    split geometry equals JAX's row for row (tri_consts, corner uvs)."""
    js, own, handed = scenes[name]
    assert own.features == tuple(js.features) and own.has_cutouts
    assert own.has_omm == js.has_omm == (name != "no_omm")
    if not js.has_omm:
        assert own.omm_summary is None and handed.omm_summary is None
        return
    for t in (own, handed):
        np.testing.assert_array_equal(t.omm_micro.numpy(),
                                      np.asarray(js.omm_micro))
        np.testing.assert_array_equal(t.omm_summary.numpy(),
                                      np.asarray(js.omm_summary))
        np.testing.assert_array_equal(t.omm_unknown_ids.numpy(),
                                      np.asarray(js.omm_unknown_ids))
        assert t.omm_level == js.omm_level == 3
        assert (t.omm_solid_geom.num_triangles
                == js.omm_solid_geom.num_triangles)
        assert (t.omm_unknown_geom.num_triangles
                == js.omm_unknown_geom.num_triangles)
        assert ((t.omm_solid_clusters is not None)
                == (js.omm_solid_clusters.num_clusters > 0))
        assert t.omm_all_certain == js.omm_all_certain
    for split in ("omm_solid_geom", "omm_unknown_geom"):
        for key in ("tri_consts", "corner_uv"):
            np.testing.assert_array_equal(
                getattr(getattr(handed, split), key).numpy(),
                np.asarray(getattr(getattr(js, split), key)))
    expect = {"cutout_cornell": (12, 20), "opaque_alpha": (32, 0),
              "cutout_grid": (1202, 0), "textured_cutout": (12, 20)}[name]
    assert (own.omm_solid_geom.num_triangles,
            own.omm_unknown_geom.num_triangles) == expect


def test_material_planes_match_jax():
    """The cutout planes of the material table (alpha mode, mask style,
    alpha cutoff with its default 0.5) equal the JAX package's."""
    materials = tb.textured_cutout_cornell_parts()[3] + [
        {"alpha_mode": tmats.ALPHA_BLEND, "alpha_cutoff": 0.25}]
    t = tmats.make_material_table(materials, "cpu")
    j = jmats.make_material_table(materials)
    for key in ("alpha_mode", "cutout", "alpha_cutoff", "checker_scale",
                "base_tex"):
        np.testing.assert_array_equal(getattr(t, key).numpy(),
                                      np.asarray(getattr(j, key)))
    assert float(t.alpha_cutoff[0]) == 0.5


def test_pack_textures_and_sample_bilinear_match_jax():
    """pack_textures' atlas, sizes and mip placements (a float RGBA map of
    odd size, a uint8 RGB map, a grey [H, W] map) within 1e-6 / equal, and
    sample_bilinear at random uvs (wrapping), texel centres and ids -1 to 2
    within 1e-6."""
    rng = np.random.default_rng(9)
    images = [rng.uniform(0, 1, (17, 9, 4)).astype(np.float32),
              rng.integers(0, 255, (8, 8, 3)).astype(np.uint8),
              rng.uniform(0, 1, (5, 12)).astype(np.float32)]
    atlas, sizes, mips = tds.pack_textures(images)
    jatlas, jsizes, jmips = jds.pack_textures(images)
    np.testing.assert_allclose(atlas, np.asarray(jatlas), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(sizes, np.asarray(jsizes))
    np.testing.assert_array_equal(mips, np.asarray(jmips))
    n = 4096
    uv = rng.uniform(-2, 3, (n, 2)).astype(np.float32)
    uv[:64] = ((np.arange(64)[:, None] % 8) + 0.5) / 8.0    # texel centres
    tid = rng.integers(-1, 3, n).astype(np.int32)
    out = sample_bilinear(torch.as_tensor(atlas), torch.as_tensor(sizes),
                          torch.as_tensor(tid), torch.as_tensor(uv))
    ref = jsample(jatlas, jsizes, jnp.asarray(tid), jnp.asarray(uv))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)
    assert (out.numpy()[tid < 0] == 1.0).all()
    empty = tds.pack_textures([])
    assert empty[0].shape == (0, 1, 1, 4)


@pytest.mark.parametrize("name", list(PARTS))
def test_occlusion_matches_jax(scenes, name):
    """_scene_any_alpha, _scene_any_alpha_omm and scene_any on 4,096 of
    bench.py's shadow rays, equal ray for ray to the JAX package's, with
    both occluded and open rays. On the grid the port's solid split runs
    its cluster table (the JAX package takes it only on a TPU and brute
    force here), and brute force over it gives the same answers."""
    js, _, t = scenes[name]
    rays, jrays = shadow_rays(name)
    with jax.disable_jit():
        ref = {"loop": np.asarray(jix._scene_any_alpha(js, jrays, None)),
               "any": np.asarray(jix.scene_any(js, jrays, None))}
        if js.has_omm:
            ref["omm"] = np.asarray(jix._scene_any_alpha_omm(js, jrays,
                                                             None))
    out = {"loop": tix._scene_any_alpha(t, rays).numpy(),
           "any": tix.scene_any(t, rays).numpy()}
    if t.has_omm:
        out["omm"] = tix._scene_any_alpha_omm(t, rays).numpy()
    for key in ref:
        np.testing.assert_array_equal(out[key], ref[key], err_msg=key)
    assert 0.0 < out["any"].mean() < 1.0
    # the micromaps change no answer (bench.py's cells compare the two)
    np.testing.assert_array_equal(out["any"], out["loop"])
    if name == "cutout_grid":
        assert t.omm_solid_clusters is not None
        brute = dataclasses.replace(t, omm_solid_clusters=None)
        np.testing.assert_array_equal(
            tix._scene_any_alpha_omm(brute, rays).numpy(), out["omm"])


def test_alpha_loop_backstop_matches_jax():
    """A ray through more than MAX_ALPHA_STEPS (64) masked surfaces counts
    as blocked (tests/test_intersect.py:139-181): 70 fully transparent
    checker quads at scale 1 and a solid quad behind them, without
    micromaps, so the loop walks them: a window holding 30 of the quads
    resolves as open, the whole stack as blocked; a ray beside them is
    open. With micromaps the quads are in no query."""
    verts, idx, uvs, tri_mat = [], [], [], []
    for i in range(71):
        b = len(verts)
        z = 1.0 + i + (1.0 if i == 70 else 0.0)
        verts += [[-1, -1, z], [1, -1, z], [1, 1, z], [-1, 1, z]]
        uvs += [[0.1, 0.1], [0.4, 0.1], [0.4, 0.4], [0.1, 0.4]]
        idx += [[b, b + 1, b + 2], [b, b + 2, b + 3]]
        tri_mat += [0 if i < 70 else 1] * 2
    materials = [{"alpha_mode": tmats.ALPHA_MASK,
                  "cutout": tmats.CUT_CHECKER, "checker_scale": 1.0},
                 {"kind": tmats.DIFFUSE}]
    parts = (np.asarray(verts, np.float32), np.asarray(idx, np.int32),
             np.asarray(tri_mat, np.int32), materials,
             np.asarray(uvs, np.float32), [], None)
    o = np.array([[0, 0, 0], [0.5, 0.5, 0], [5, 5, 0]], np.float32)
    d = np.array([[0, 0, 1]] * 3, np.float32)
    for tmax, blocked in ((30.5, False), (1e4, True)):
        js = jax_scene(parts, opacity_micromaps=False)
        t = tds.device_scene_from_numpy(scene_fields(js), "cpu")
        tm = np.full(3, tmax, np.float32)
        rays = Rays(torch.as_tensor(o), torch.as_tensor(d),
                    torch.full((3,), 1e-3), torch.as_tensor(tm))
        jrays = JRays(origin=jnp.asarray(o), direction=jnp.asarray(d),
                      tmin=jnp.full((3,), 1e-3, jnp.float32),
                      tmax=jnp.asarray(tm))
        out = tix.scene_any(t, rays).numpy()
        np.testing.assert_array_equal(
            out, np.asarray(jix.scene_any(js, jrays, None)))
        assert out.tolist() == [blocked, blocked, False]
    # with micromaps the transparent quads are in no query: the short rays
    # pass, the long ones reach the solid quad
    t = tb.scene_from_parts(parts, "cpu")
    assert t.omm_unknown_geom.num_triangles == 0
    assert t.omm_solid_geom.num_triangles == 2
    for tmax, blocked in ((30.5, False), (1e4, True)):
        rays = Rays(torch.as_tensor(o), torch.as_tensor(d),
                    torch.full((3,), 1e-3), torch.full((3,), tmax))
        assert tix.scene_any(t, rays).tolist() == [blocked, blocked, False]
