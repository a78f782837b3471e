"""The port's core/, shade/ and scene/ against the JAX package on the CPU:
RNG words equal, camera rays within 1e-6, Cornell tables equal, scene
constants carried across bit for bit (and rebuilt within 1e-6 relative)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_raytracer_tpu.core import camera as jcamera
from optix_raytracer_tpu.core import film as jfilm
from optix_raytracer_tpu.core import rng as jrng
from optix_raytracer_tpu.scene import builtins as jbuiltins
from optix_raytracer_tpu.shade import lights as jlights
from optix_raytracer_tpu.shade import materials as jmaterials
from optix_raytracer_tpu_torch.core import camera as tcamera
from optix_raytracer_tpu_torch.core import film as tfilm
from optix_raytracer_tpu_torch.core import rng as trng
from optix_raytracer_tpu_torch.scene import builtins as tbuiltins
from optix_raytracer_tpu_torch.shade import materials as tmaterials

from torch_parity import scene_fields, torch_cam, torch_scene


def _words(seed, n):
    """n random 32-bit words, half of them >= 2**31."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 2 ** 31, n // 2, dtype=np.int64)
    hi = rng.integers(2 ** 31, 2 ** 32, n - n // 2, dtype=np.int64)
    return np.concatenate([lo, hi])


class TestRNG:
    N = 100_000

    def test_tea_seed_word_for_word(self):
        a, b = _words(1, self.N), _words(2, self.N)
        ref = np.asarray(jrng.seed(jnp.asarray(a.astype(np.uint32)),
                                   jnp.asarray(b.astype(np.uint32))))
        out = trng.seed(torch.as_tensor(a), torch.as_tensor(b)).numpy()
        np.testing.assert_array_equal(out, ref.astype(np.int64))

    def test_pcg_uniform_streams_word_for_word(self):
        s = _words(3, self.N)
        js = jnp.asarray(s.astype(np.uint32))
        ts = torch.as_tensor(s)
        for _ in range(3):  # three draws deep, so chained states match too
            jw, js_next = jrng.pcg(js)
            tw, ts_next = trng.pcg(ts)
            np.testing.assert_array_equal(tw.numpy(),
                                          np.asarray(jw).astype(np.int64))
            ju1, ju2, js = jrng.uniform2(js)
            tu1, tu2, ts = trng.uniform2(ts)
            np.testing.assert_array_equal(tu1.numpy(), np.asarray(ju1))
            np.testing.assert_array_equal(tu2.numpy(), np.asarray(ju2))
            np.testing.assert_array_equal(ts.numpy(),
                                          np.asarray(js).astype(np.int64))

    def test_int32_and_python_int_seeds(self):
        """Negative int32 views and Python ints are the same 32-bit words."""
        a = _words(4, 1000)
        as_i32 = torch.as_tensor(a.astype(np.uint32).view(np.int32))
        np.testing.assert_array_equal(trng.seed(as_i32, 7).numpy(),
                                      trng.seed(torch.as_tensor(a), 7).numpy())


@pytest.mark.parametrize("kind", ["pinhole", "ortho", "thin_lens"])
def test_generate_rays_matches_jax(kind):
    """Jittered camera rays equal the JAX ones (atol 1e-6), row tile too."""
    cam = jcamera.Camera(eye=(0.3, 0.2, 4.0), lookat=(0.0, 0.1, 0.0),
                         fov_y=40.0, aspect=1.25,
                         aperture=0.15 if kind == "thin_lens" else 0.0,
                         focal_distance=3.5,
                         orthographic=kind == "ortho", ortho_height=2.5)
    w, h, full_h = 20, 8, 16
    jp = cam.params()
    state = _words(5, w * h).reshape(h, w)
    jr, jnext = jcamera.generate_rays(jp, w, h,
                                      rng_state=jnp.asarray(
                                          state.astype(np.uint32)),
                                      y0=8, full_height=full_h)
    tr, tnext = tcamera.generate_rays(torch_cam(jp), w, h,
                                      rng_state=torch.as_tensor(state),
                                      y0=8, full_height=full_h)
    np.testing.assert_allclose(tr.origin.numpy(), np.asarray(jr.origin),
                               atol=1e-6 * 4.0)  # |origin| ~ 4: 1e-6 relative
    np.testing.assert_allclose(tr.direction.numpy(), np.asarray(jr.direction),
                               atol=1e-6)
    np.testing.assert_array_equal(tnext.numpy(),
                                  np.asarray(jnext).astype(np.int64))
    np.testing.assert_allclose(tr.tmin.numpy(), np.asarray(jr.tmin))


def test_vecmath_matches_jax():
    from optix_raytracer_tpu.core import vecmath as jv
    from optix_raytracer_tpu_torch.core import vecmath as tv
    rng = np.random.default_rng(10)
    a, b = rng.normal(size=(2, 50, 3)).astype(np.float32)
    n = a / np.linalg.norm(a, axis=1, keepdims=True)
    for name, args in (("dot", (a, b)), ("cross", (a, b)),
                       ("normalize", (b,)), ("reflect", (b, n))):
        np.testing.assert_allclose(
            getattr(tv, name)(*map(torch.as_tensor, args)).numpy(),
            np.asarray(getattr(jv, name)(*map(jnp.asarray, args))),
            rtol=1e-6, atol=1e-6)
    for t_out, j_out in zip(tv.orthonormal_basis(torch.as_tensor(n)),
                            jv.orthonormal_basis(jnp.asarray(n))):
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                                   atol=1e-6)


def test_camera_params_match_jax():
    cam = jbuiltins.cornell_camera(32, 24)
    tp = tbuiltins.cornell_camera(32, 24).params("cpu")
    for k, v in cam.params().items():
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(v))


def test_cornell_tables_equal_jax():
    assert tbuiltins._CORNELL_QUADS == jbuiltins._CORNELL_QUADS
    assert tbuiltins.CORNELL_MATERIALS == jbuiltins.CORNELL_MATERIALS
    for name in ("CORNELL_LIGHT_CORNER", "CORNELL_LIGHT_V1",
                 "CORNELL_LIGHT_V2", "CORNELL_LIGHT_EMISSION", "WHITE",
                 "GREEN", "RED", "LIGHT"):
        assert getattr(tbuiltins, name) == getattr(jbuiltins, name)
    for name in ("DIFFUSE", "PBR", "GLASS", "PHONG", "CHECKER", "EMISSIVE"):
        assert getattr(tmaterials, name) == getattr(jmaterials, name)


def test_cornell_box_matches_jax():
    """The port's own Cornell build vs the JAX scene: geometry constants
    within 1e-6 relative, everything else equal."""
    ref = scene_fields(jbuiltins.cornell_box())
    own = tbuiltins.cornell_box("cpu")
    tc = own.geom.tri_consts.numpy()
    scale = np.abs(ref["tri_consts"]).max(axis=1, keepdims=True)
    np.testing.assert_allclose(tc / scale, ref["tri_consts"] / scale,
                               atol=1e-6)
    np.testing.assert_array_equal(own.geom.valid.numpy(), ref["valid"])
    np.testing.assert_array_equal(own.tri_mat.numpy(), ref["tri_mat"])
    m = own.materials
    for key, val in (("mat_kind", m.kind), ("mat_base_color", m.base_color),
                     ("mat_emission", m.emission), ("mat_ior", m.ior),
                     ("mat_metallic", m.metallic), ("mat_kr", m.kr),
                     ("mat_roughness", m.roughness)):
        np.testing.assert_array_equal(val.numpy(), ref[key])
    light = own.area_light
    jl = jlights.ParallelogramLight.make(
        jbuiltins.CORNELL_LIGHT_CORNER, jbuiltins.CORNELL_LIGHT_V1,
        jbuiltins.CORNELL_LIGHT_V2, jbuiltins.CORNELL_LIGHT_EMISSION)
    np.testing.assert_allclose(light.normal.numpy(), ref["light_normal"],
                               atol=1e-7)
    np.testing.assert_allclose(float(light.area), float(jl.area), rtol=1e-7)
    np.testing.assert_array_equal(own.miss_color.numpy(), ref["miss_color"])
    assert own.features == ()


def test_degenerate_triangle_is_zeroed():
    rng = np.random.default_rng(6)
    verts = rng.uniform(-1, 1, (9, 3)).astype(np.float32)
    verts[5] = verts[4]                       # triangle 1 collapses
    idx = np.arange(9, dtype=np.int32).reshape(3, 3)
    from optix_raytracer_tpu.accel.geometry import build_triangle_geometry as jb
    from optix_raytracer_tpu_torch.accel.geometry import build_triangle_geometry
    g = build_triangle_geometry(verts, idx, "cpu")
    jg = jb(verts, idx)
    np.testing.assert_array_equal(g.valid.numpy(), np.asarray(jg.valid))
    assert not g.valid[1]
    np.testing.assert_array_equal(g.tri_consts[1, :12].numpy(), 0.0)
    np.testing.assert_allclose(g.tri_consts.numpy(),
                               np.asarray(jg.tri_consts), rtol=1e-6,
                               atol=1e-6)


def test_device_scene_from_numpy_is_bit_exact():
    js = jbuiltins.cornell_box()
    ts = torch_scene(js)
    np.testing.assert_array_equal(ts.geom.tri_consts.numpy(),
                                  np.asarray(js.geom.tri_consts))
    np.testing.assert_array_equal(ts.area_light.normal.numpy(),
                                  np.asarray(js.area_light.normal))
    assert float(ts.area_light.area) == float(js.area_light.area)
    assert ts.features == js.features
    ts.require_supported()
    # the light table and the Whitted material planes, carried across and
    # built by the port's own whitted_scene
    jw = jbuiltins.whitted_scene()
    own = tbuiltins.whitted_scene("cpu")
    for tw in (torch_scene(jw), own):
        for key in ("kind", "position", "color", "falloff", "radius"):
            np.testing.assert_array_equal(
                getattr(tw.lights, key).numpy(),
                np.asarray(getattr(jw.lights, key)))
        for key in ("specular", "phong_exp", "checker1", "checker_scale",
                    "kr", "ior", "base_color"):
            np.testing.assert_array_equal(
                getattr(tw.materials, key).numpy(),
                np.asarray(getattr(jw.materials, key)))
        np.testing.assert_array_equal(tw.prims.params.numpy(),
                                      np.asarray(jw.prims.params))
        np.testing.assert_array_equal(tw.miss_color.numpy(),
                                      np.asarray(jw.miss_color))
        assert tw.lights.num == 2 and tw.features == jw.features


def test_unported_features_raise():
    fields = scene_fields(jbuiltins.cornell_box())
    from optix_raytracer_tpu_torch.scene.device_scene import (
        device_scene_from_numpy)
    # a feature tag the port does not know raises; fog volumes are ported
    # (ROADMAP.md Queue 1 item 9), so "volume" is served
    fields["features"] = ("hair_bsdf",)
    with pytest.raises(ValueError, match="unknown scene features"):
        device_scene_from_numpy(fields, "cpu").require_supported()
    fields["features"] = ("volume",)
    vscene = device_scene_from_numpy(fields, "cpu")
    vscene.require_supported()
    assert vscene.has_volume and vscene.volume.density.shape == (1, 1, 1)
    # alpha cutouts are ported: their planes build, the feature is served
    fields["features"] = ("cutouts",)
    device_scene_from_numpy(fields, "cpu").require_supported()
    table = tmaterials.make_material_table([{"cutout": 1},
                                            {"alpha_mode": 1}], "cpu")
    assert table.cutout.tolist() == [1, 0]
    assert table.alpha_mode.tolist() == [0, 1]
    # texture ids are ported (the bundle id comes with the scene's textures)
    table = tmaterials.make_material_table([{"base_tex": 0}], "cpu")
    assert int(table.base_tex[0]) == 0 and int(table.bundle[0]) == -1
    with pytest.raises(ValueError):
        fields = scene_fields(jbuiltins.cornell_box())
        fields["tri_mat"] = fields["tri_mat"] + 10
        device_scene_from_numpy(fields, "cpu")


def test_film_color_matches_jax():
    rng = np.random.default_rng(8)
    rad = rng.uniform(-0.1, 1.5, (6, 7, 3)).astype(np.float32)
    rad[0, 0] = [0.0, 0.003, 0.0031308]
    np.testing.assert_allclose(
        tfilm.linear_to_srgb(torch.as_tensor(rad)).numpy(),
        np.asarray(jfilm.linear_to_srgb(jnp.asarray(rad))), atol=1e-6)
    out = tfilm.make_color(torch.as_tensor(rad)).numpy()
    ref = np.asarray(jfilm.make_color(jnp.asarray(rad)))
    assert out.dtype == np.uint8 and out.shape == (6, 7, 4)
    # a one-ulp sRGB difference may cross an 8-bit step
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
    f = tfilm.Film.create(4, 5, "cpu", track_variance=True)
    assert f.subframe.dtype == torch.int64 and f.accum.shape == (4, 5, 3)
    assert f.sq.shape == (4, 5, 3) and int(f.launches) == 0
