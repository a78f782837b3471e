"""Textured path tracing in the port on the CPU, against the JAX package:
the material texture bundles (scene/device_scene.py::pack_bundles), the
geometry's uvs, tangents and uv densities, the bundle fetch
(shade/texture.py::sample_bundle), the wavefront's texture lanes (the plain
version of the fused kernel's texture variant) against the XLA engine and
the Pallas texture megakernel in interpret mode, the mirror lanes a
metallic-roughness map makes, `_use_fused`'s texture rule and the host
Scene's textures.

The scenes are tests/test_fused_textures.py:29-63's (builtins.textured_scene
with 32 / 16 / 16 / 8 maps, metallic 0.6, roughness 0.8): all four maps,
smooth normals, the base map alone. Bars: pack_bundles bit-equal; the
geometry and the fetch within 1e-6; renders with equal ray counts and
radiance within atol 2e-3 / rtol 1e-3 of the XLA engine
(tests/test_fused_kernel.py:77-78) and atol 1e-3 of the megakernel under
ORT_TEX_F32=1 (tests/test_fused_textures.py:89)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from optix_raytracer_tpu.accel.geometry import (
    build_triangle_geometry as jgeom, shading_frame as jframe)
from optix_raytracer_tpu.core.camera import Camera as JCamera
from optix_raytracer_tpu.scene import device_scene as jds
from optix_raytracer_tpu.scene.scene import Scene as JScene
from optix_raytracer_tpu.shade import texture as jtex
from optix_raytracer_tpu.shade.lights import ParallelogramLight as JLight
from optix_raytracer_tpu.wavefront import engine as jengine
from optix_raytracer_tpu.wavefront import pallas_pt as jpt
from optix_raytracer_tpu_torch import kernels
from optix_raytracer_tpu_torch.accel.geometry import (build_triangle_geometry,
                                                      shading_frame)
from optix_raytracer_tpu_torch.scene import builtins as tb
from optix_raytracer_tpu_torch.scene import device_scene as tds
from optix_raytracer_tpu_torch.scene.device_scene import DeviceScene
from optix_raytracer_tpu_torch.scene.scene import Scene
from optix_raytracer_tpu_torch.shade.lights import ParallelogramLight
from optix_raytracer_tpu_torch.shade.texture import sample_bundle
from optix_raytracer_tpu_torch.wavefront import engine, pallas_pt

from torch_parity import (one_torch_thread, scene_fields,  # noqa: F401
                          torch_cam, torch_scene)

BARS = dict(atol=2e-3, rtol=1e-3)
TOL = dict(atol=1e-6, rtol=1e-6)
SMALL = (32, 16, 16, 8)
_VERTS = np.array([[-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3],
                   [-1, 0, -0.5], [1, 0, -0.5], [1, 1.6, -0.5],
                   [-1, 1.6, -0.5]], np.float32)
_IDX = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7]], np.int32)
_UVS = np.array([[0, 0], [4, 0], [4, 4], [0, 4], [0, 0], [2, 0], [2, 2],
                 [0, 2]], np.float32)
_LIGHT = ((-1.0, 3.0, -1.0), (2, 0, 0), (0, 0, 2), (8.0, 8.0, 8.0))


def jax_textured(metallic=0.6, roughness=0.8, smooth=False, maps="all",
                 sizes=SMALL, mr_map=None):
    """The JAX twin of builtins.textured_scene (tests/test_fused_textures.py
    :29-63 at its default sizes); mr_map replaces the metallic-roughness
    map."""
    normals = None
    if smooth:
        normals = np.zeros((8, 3), np.float32)
        normals[:4] = (0, 1, 0)
        nr = np.array([0.3, 0.2, -0.93], np.float32)
        normals[4:] = nr / np.linalg.norm(nr)
    m = {"kind": 1, "base_color": (1, 1, 1), "base_tex": 0,
         "emission": (1.0, 1.0, 1.0), "metallic": metallic,
         "roughness": roughness}
    if maps == "all":
        m.update(normal_tex=1, mr_tex=2, emissive_tex=3)
    textures = tb.textured_maps(sizes)
    if mr_map is not None:
        textures[2] = mr_map
    return jds.make_device_scene(_VERTS, _IDX, np.zeros(4, np.int32), [m],
                                 uvs=_UVS, normals=normals,
                                 textures=textures,
                                 area_light=JLight.make(*_LIGHT))


def _jcam(w, h, fov=45.0):
    return JCamera(eye=(0, 1.5, -4.5), lookat=(0, 0.6, 0), up=(0, 1, 0),
                   fov_y=fov, aspect=w / h).params()


def _images():
    """Maps of odd, non-square and tiny sizes, uint8, grey and RGBA."""
    rng = np.random.default_rng(5)
    return [rng.uniform(0, 1, (30, 20, 3)).astype(np.float32),
            rng.integers(0, 255, (7, 5, 3)).astype(np.uint8),
            rng.uniform(0, 1, (16, 16)).astype(np.float32),
            rng.uniform(0, 1, (9, 12, 4)).astype(np.float32),
            rng.uniform(0, 1, (1, 1, 3)).astype(np.float32)]


_MATERIALS = [
    {"kind": 1, "base_tex": 0, "normal_tex": 1, "mr_tex": 2,
     "emissive_tex": 3},
    {"kind": 0},                                        # untextured
    {"kind": 0, "base_tex": 1},
    {"kind": 1, "base_tex": 0, "normal_tex": 1, "mr_tex": 2,
     "emissive_tex": 3},                                # shares bundle 0
    {"kind": 0, "mr_tex": 4, "emissive_tex": 2},
]


# --- the bundles and the geometry ----------------------------------------------

def test_pack_bundles_bit_equal():
    """The port's pack_bundles against the reference's on maps of odd and
    tiny sizes, with shared and untextured materials: atlas, levels, the
    materials' bundle ids and the level sizes equal bit for bit."""
    bundles, mips, mat_bundle, meta = tds.pack_bundles(_images(), _MATERIALS)
    ref = jds.pack_bundles(_images(), _MATERIALS)
    np.testing.assert_array_equal(bundles, np.asarray(ref[0]))
    np.testing.assert_array_equal(mips, np.asarray(ref[1]))
    np.testing.assert_array_equal(mat_bundle, np.asarray(ref[2]))
    assert meta == ref[5]
    assert list(mat_bundle) == [0, -1, 1, 0, 2]
    assert tds.pack_bundles(_images(), [{"kind": 0}])[0].shape == (0, 1, 1, 16)


def test_bench_bundle_shape():
    """bench.py's textured scene: 4 triangles, one bundle of 256x256
    texels and 9 levels, 6.5 MB, its material's flags all on; the PBR
    material's mr map makes specular lanes possible and picks the
    <tex, specular, pbr> instantiation."""
    scene = tb.textured_scene("cpu")
    assert scene.num_triangles == 4 and scene.num_textures == 4
    assert scene.bundle_meta[0][0] == (256, 256) and len(
        scene.bundle_meta[0]) == 9
    assert tuple(scene.bundles.shape) == (1, 263, 386, 16)
    assert scene.mat_tex_flags == ((0, True, True, True, True),)
    assert scene.features == ("pbr",) and scene.specular_lanes
    assert not scene.has_specular
    assert kernels.pt_fused_name(*pallas_pt.fused_variant(scene)) == (
        "pt_fused_tex_specular_pbr")


def test_geometry_uv_frame_matches_jax():
    """corner uvs, tangents and uv densities (degenerate uv triangles take
    e1 and density 0) and shading_frame's uv / tangent / uv_density at
    random hits, against the reference's."""
    rng = np.random.default_rng(4)
    m = 50
    verts = rng.normal(size=(3 * m, 3)).astype(np.float32)
    idx = np.arange(3 * m, dtype=np.int32).reshape(m, 3)
    uvs = rng.uniform(-2, 3, (3 * m, 2)).astype(np.float32)
    uvs[0:3] = (0.5, 0.5)                        # triangle 0: no uv area
    uvs[3:6] = [(0, 0), (1, 1), (2, 2)]          # triangle 1: collinear
    g = build_triangle_geometry(verts, idx, "cpu", uvs=uvs)
    jg = jgeom(verts, idx, uvs=uvs)
    for k in ("corner_uv", "tangent", "uv_density"):
        np.testing.assert_allclose(getattr(g, k).numpy(),
                                   np.asarray(getattr(jg, k)), **TOL,
                                   err_msg=k)
    np.testing.assert_array_equal(g.uv_density[:2].numpy(), 0.0)
    pid = rng.integers(0, m, 300).astype(np.int32)
    bary = rng.uniform(0, 0.5, (300, 2)).astype(np.float32)
    own = shading_frame(g, torch.as_tensor(pid), torch.as_tensor(bary))
    ref = jframe(jg, jnp.asarray(pid), jnp.asarray(bary))
    for k in ("uv", "tangent", "uv_density", "shading_normal"):
        np.testing.assert_allclose(own[k].numpy(), np.asarray(ref[k]), **TOL,
                                   err_msg=k)
    flat = build_triangle_geometry(verts, idx, "cpu")
    np.testing.assert_array_equal(flat.corner_uv.numpy(), 0.0)


@pytest.mark.parametrize("quads", [False, True])
def test_sample_bundle_matches_jax(quads):
    """The port's fetch against the reference's (2, 2, 16)-slice form and
    its quad-row form: uvs outside [0, 1] (wrap), ids -1 (neutral) and of
    every bundle, texel scales 0, inside the chain and past it (clipped to
    the last level)."""
    bundles, mips, _, qrows, qbase = (np.array(a) for a in
                                    jds.pack_bundles(_images(),
                                                     _MATERIALS)[:5])
    rng = np.random.default_rng(8)
    n = 3000
    uv = rng.uniform(-3, 5, (n, 2)).astype(np.float32)
    bid = rng.integers(-1, bundles.shape[0], n).astype(np.int32)
    scale = np.exp(rng.uniform(-9, 3, n)).astype(np.float32)
    scale[:200] = 0.0
    scale[200:400] = 1e6
    ref = jtex.sample_bundle(jnp.asarray(bundles), jnp.asarray(mips),
                             jnp.asarray(bid), jnp.asarray(uv),
                             texel_scale=jnp.asarray(scale),
                             quads=jnp.asarray(qrows) if quads else None,
                             quad_base=jnp.asarray(qbase) if quads else None)
    out = sample_bundle(torch.as_tensor(bundles), torch.as_tensor(mips),
                        torch.as_tensor(bid), torch.as_tensor(uv),
                        texel_scale=torch.as_tensor(scale))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(out.numpy()[bid < 0][:, 4],
                                  np.float32(0.5))
    level0 = sample_bundle(torch.as_tensor(bundles), torch.as_tensor(mips),
                           torch.as_tensor(bid), torch.as_tensor(uv))
    assert not torch.equal(level0, out)


# --- the wavefront's texture lanes -----------------------------------------------

_SCENES = {"all": {}, "smooth": dict(smooth=True), "base": dict(maps="base")}


@pytest.mark.parametrize("name", list(_SCENES))
def test_render_sample_matches_jax(name):
    """engine.render_sample with the texture lanes against the XLA
    render_sample, 32², depth 2: all four maps (flat meshes shade through
    the interpolated frame), smooth normals, the base map alone."""
    js = jax_textured(**_SCENES[name])
    ts = torch_scene(js)
    assert ts.has_textures and ts.bundles.shape[0] == 1
    jcam = _jcam(32, 32)
    ref, ref_count = jengine.render_sample(js, jcam, 32, 32, 0, max_depth=2,
                                           chunk_size=None)
    out, count = engine.render_sample(ts, torch_cam(jcam), 32, 32, 0,
                                      max_depth=2)
    assert int(count) == int(float(ref_count))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **BARS)
    assert float(out.max()) > 0.05


def test_own_scene_matches_handed_over():
    """The port's own textured_scene equals the JAX-built twin handed over:
    the bundle atlas, levels and uv frame bit for bit, renders within the
    bars with equal rays."""
    own = tb.textured_scene("cpu", SMALL, 0.6, 0.8)
    ts = torch_scene(jax_textured())
    assert torch.equal(own.bundles, ts.bundles)
    assert torch.equal(own.bundle_mip, ts.bundle_mip)
    assert own.bundle_meta == ts.bundle_meta
    assert own.mat_tex_flags == ts.mat_tex_flags
    for k in ("corner_uv", "tangent", "uv_density"):
        np.testing.assert_allclose(getattr(own.geom, k).numpy(),
                                   getattr(ts.geom, k).numpy(), **TOL)
    cam = tb.textured_camera(16, 16, 45.0).params("cpu")
    a, ca = engine.render_sample(own, cam, 16, 16, 3, max_depth=2)
    b, cb = engine.render_sample(ts, cam, 16, 16, 3, max_depth=2)
    assert int(ca) == int(cb)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **BARS)


def _mirror_map():
    """A metallic-roughness map whose left half is polished metal (G 0.02,
    B 1.0) and right half rough dielectric: on a metallic 1, roughness 1
    material its left half makes mirror lanes."""
    mr = np.zeros((16, 16, 3), np.float32)
    mr[:, :8] = (0.0, 0.02, 1.0)
    mr[:, 8:] = (0.0, 0.8, 0.3)
    return mr


def test_mr_map_mirror_lanes_match_jax():
    """A PBR material (metallic 1, roughness 1: the scene's features are
    ("pbr",), no mirror) whose mr map makes mirror lanes, as the engine
    reads them after the map (engine.py:378-384, 479-481): the port's
    specular gate is on, the render matches the XLA engine, and with the
    gate forced off it would not."""
    js = jax_textured(1.0, 1.0, mr_map=_mirror_map())
    ts = torch_scene(js)
    assert ts.features == ("pbr",) and ts.specular_lanes
    assert pallas_pt.fused_variant(ts)[:2] == (True, True)
    jcam = _jcam(32, 32)
    ref, ref_count = jengine.render_sample(js, jcam, 32, 32, 0, max_depth=3,
                                           chunk_size=None)
    out, count = engine.render_sample(ts, torch_cam(jcam), 32, 32, 0,
                                      max_depth=3)
    assert int(count) == int(float(ref_count))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **BARS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DeviceScene, "specular_lanes", property(lambda s: False))
        gated, _ = engine.render_sample(ts, torch_cam(jcam), 32, 32, 0,
                                        max_depth=3)
    assert float((gated - out).abs().max()) > 1e-2


def test_fused_plain_matches_megakernel(monkeypatch):
    """render_sum_fused on CPU tensors (the plain version of the texture
    variant) against the Pallas texture megakernel in interpret mode under
    ORT_TEX_F32=1 (f32 filtering), all four maps, 32², spl 1, depth 2."""
    monkeypatch.setenv("ORT_TEX_F32", "1")
    js = jax_textured()
    jcam = _jcam(32, 32)
    ref, ref_count = jpt.render_sum_fused(js, jcam, 32, 32, 0,
                                          samples_per_launch=1, max_depth=2,
                                          interpret=True)
    out, count = pallas_pt.render_sum_fused(torch_scene(js), torch_cam(jcam),
                                            32, 32, 0, samples_per_launch=1,
                                            max_depth=2)
    assert int(count) == int(float(ref_count))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["smooth", "base"])
def test_fused_plain_matches_megakernel_sweep(monkeypatch, name):
    """The same on the smooth and base-map-only scenes."""
    monkeypatch.setenv("ORT_TEX_F32", "1")
    js = jax_textured(**_SCENES[name])
    jcam = _jcam(32, 32)
    ref, ref_count = jpt.render_sum_fused(js, jcam, 32, 32, 0,
                                          samples_per_launch=1, max_depth=2,
                                          interpret=True)
    out, count = pallas_pt.render_sum_fused(torch_scene(js), torch_cam(jcam),
                                            32, 32, 0, samples_per_launch=1,
                                            max_depth=2)
    assert int(count) == int(float(ref_count))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3)


# --- dispatch and the host Scene ---------------------------------------------

def _textured_instanced(package):
    """A textured quad instanced twice, built by `package`'s Scene."""
    if package == "jax":
        sc = JScene()
    else:
        sc = Scene()
    for im in tb.textured_maps(SMALL):
        sc.add_texture(im)
    sc.add_material({"kind": 0, "base_tex": 0, "normal_tex": 1})
    quad = sc.add_mesh(_VERTS[4:], _IDX[2:] - 4, uvs=_UVS[4:])
    t = np.eye(4, dtype=np.float32)
    t[0, 3] = 1.5
    sc.add_instance(quad)
    sc.add_instance(quad, t)
    if package == "jax":
        return sc.finalize(area_light=JLight.make(*_LIGHT))
    return sc.finalize("cpu", area_light=ParallelogramLight.make(*_LIGHT,
                                                                 "cpu"))


def test_use_fused_texture_rule(monkeypatch):
    """"auto" takes the texture variant for a textured scene with a bundle,
    never for one without (textures no material reads) or with instances,
    and forcing an instanced one onto the kernel raises; the wavefront
    renders it."""
    scene = tb.textured_scene("cpu", SMALL, 0.6, 0.8)
    inst = _textured_instanced("torch")
    sc = Scene()
    sc.add_texture(tb.textured_maps(SMALL)[0])
    sc.add_material({"kind": 0})
    sc.add_mesh(_VERTS, _IDX)
    unread = sc.finalize("cpu", area_light=ParallelogramLight.make(*_LIGHT,
                                                                   "cpu"))
    assert unread.has_textures and unread.bundles.shape[0] == 0
    cam = tb.textured_camera(8, 8).params("cpu")
    with pytest.raises(ValueError):
        pallas_pt.render_sum_fused(inst, cam, 8, 8, 0)
    img, rays = engine.render_sum_wavefront(inst, cam, 8, 8, 0, 1,
                                            max_depth=2)
    assert int(rays) > 0 and bool(torch.isfinite(img).all())
    monkeypatch.setattr(DeviceScene, "device",
                        property(lambda self: torch.device("cuda")))
    assert engine._use_fused(scene, "auto")
    assert engine._use_fused(scene, "fused")
    assert not engine._use_fused(scene, "wavefront")
    assert not engine._use_fused(inst, "auto")
    assert not engine._use_fused(unread, "auto")


def test_fused_tables_textured():
    """The texture variant's scene tables, packed once per scene: the
    material rows carry the bundle id, the map flags with the chain length
    and the level-0 size; the attribute plane the corner normals, uvs,
    tangent and uv density; a replaced scene packs anew."""
    import dataclasses
    scene = tb.textured_scene("cpu", SMALL, 0.6, 0.8)
    tables = scene.fused_tables
    assert scene.fused_tables is tables
    assert tables["variant"] == (True, True, False, pallas_pt.TEX)
    row = tables["mats"][0]
    assert float(row[13]) == 0.0
    flags = (pallas_pt.TEX_BASE | pallas_pt.TEX_NORMAL | pallas_pt.TEX_MR
             | pallas_pt.TEX_EMISSIVE)
    chain = len(scene.bundle_meta[0])
    assert float(row[14]) == flags + (chain << pallas_pt.TEX_CHAIN_SHIFT)
    assert float(row[15]) == max(scene.bundle_meta[0][0]) == SMALL[0]
    corner = tables["corner"]
    m = scene.num_triangles
    assert tuple(corner.shape) == (m, pallas_pt.TEX_ATTR_COLS)
    g = scene.geom
    assert torch.equal(corner[:, 0:9], g.corner_normal.reshape(m, 9))
    assert torch.equal(corner[:, 9:15], g.corner_uv.reshape(m, 6))
    assert torch.equal(corner[:, 15:18], g.tangent)
    assert torch.equal(corner[:, 18], g.uv_density)
    assert torch.equal(tables["tri"][:, 15], scene.tri_mat.float())
    base = tb.textured_scene("cpu", SMALL, 0.6, 0.8, maps="base")
    assert float(base.fused_tables["mats"][0, 14]) == (
        pallas_pt.TEX_BASE
        + (len(base.bundle_meta[0]) << pallas_pt.TEX_CHAIN_SHIFT))
    again = dataclasses.replace(scene)
    assert again.fused_tables is not tables
    assert torch.equal(again.fused_tables["mats"], tables["mats"])


def test_scene_textures_match_jax():
    """Scene.add_texture → finalize: the port's fields equal the JAX
    Scene's (a second mesh without uvs gets zero uvs), flat and
    instanced."""
    def build(package):
        sc = JScene() if package == "jax" else Scene()
        for im in _images():
            sc.add_texture(im)
        for m in _MATERIALS:
            sc.add_material(m)
        sc.add_mesh(_VERTS, _IDX, uvs=_UVS, material=0)
        sc.add_mesh(_VERTS[:4] + 1.0, _IDX[:2], material=2)
        if package == "jax":
            return sc.finalize()
        return sc.finalize("cpu")

    own, ref = build("torch"), torch_scene(build("jax"))
    for a, b in ((own, ref), (_textured_instanced("torch"),
                              torch_scene(_textured_instanced("jax")))):
        assert torch.equal(a.bundles, b.bundles)
        assert torch.equal(a.bundle_mip, b.bundle_mip)
        assert a.bundle_meta == b.bundle_meta
        assert a.mat_tex_flags == b.mat_tex_flags
        assert a.num_textures == b.num_textures
        assert torch.equal(a.materials.bundle, b.materials.bundle)
        for k in ("base_tex", "normal_tex", "mr_tex", "emissive_tex"):
            assert torch.equal(getattr(a.materials, k),
                               getattr(b.materials, k))
        for k in ("corner_uv", "tangent", "uv_density"):
            np.testing.assert_allclose(getattr(a.geom, k).numpy(),
                                       getattr(b.geom, k).numpy(), **TOL)
    np.testing.assert_array_equal(own.geom.corner_uv[4:].numpy(), 0.0)
    assert scene_fields(build("jax"))["num_textures"] == 5
