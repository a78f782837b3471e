"""The fused kernel's specular, PBR and prim variants (3') on the CPU: the
port's refraction and GGX sampling, its PBR BRDF and pdf, its wavefront
engine and the plain version of the fused kernel, against the JAX package
(the XLA engine, and the Pallas megakernel in interpret mode), and the
port's fused-kernel dispatch rule.

Both sides draw the same RNG streams, so traced-ray counts must be equal;
radiance agrees within atol 3e-3 / rtol 1e-3 on the prims scenes
(tests/test_fused_kernel.py:238) and atol 2e-3 / rtol 1e-3 otherwise
(f32 reassociation noise: XLA contracts a*b+c into FMAs inside jit, the
port does not). The helpers (refract, GGX, BRDF, pdf) agree within 1e-6."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_raytracer_tpu.core.camera import Camera as JCamera
from optix_raytracer_tpu.core.vecmath import refract as jrefract
from optix_raytracer_tpu.scene import builtins as jb
from optix_raytracer_tpu.shade.sampling import (
    ggx_sample_half_vector as jggx)
from optix_raytracer_tpu.wavefront import engine as jengine
from optix_raytracer_tpu.wavefront.pallas_pt import render_sum_fused as jfused
from optix_raytracer_tpu_torch.accel import primitives as prim
from optix_raytracer_tpu_torch.core.vecmath import refract
from optix_raytracer_tpu_torch.scene import builtins as tb
from optix_raytracer_tpu_torch.scene.device_scene import (DeviceScene,
                                                          make_device_scene)
from optix_raytracer_tpu_torch.shade import materials as M
from optix_raytracer_tpu_torch.shade.sampling import ggx_sample_half_vector
from optix_raytracer_tpu_torch.wavefront import engine, pallas_pt

from torch_parity import (jax_pbr_cornell, jax_prims_scene, torch_cam,
                          torch_scene)

PRIMS_BARS = dict(atol=3e-3, rtol=1e-3)
BARS = dict(atol=2e-3, rtol=1e-3)
HELPER_TOL = dict(atol=1e-6, rtol=1e-6)


def _jcam(tcam):
    return JCamera(eye=tcam.eye, lookat=tcam.lookat, up=tcam.up,
                   fov_y=tcam.fov_y, aspect=tcam.aspect).params()


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_refract_matches_jax():
    """Both sides of the interface, eta 1/1.5 and 1.5; past the critical
    angle (entering the rarer medium) the direction is zero and ok False.
    Samples within ~1 degree of the critical angle are left out: there
    sqrt(1 - sin²) turns the ulp by which the two libraries' dot products
    may differ into more than 1e-6."""
    rng = np.random.default_rng(0)
    n = 700
    nrm = _unit(rng, n)
    i = _unit(rng, n)
    i = np.where((np.sum(i * nrm, 1) > 0)[:, None], -i, i)   # toward surface
    eta = np.where(rng.random(n) < 0.5, 1 / 1.5, 1.5).astype(np.float32)
    cos_i = -np.sum(i.astype(np.float64) * nrm, 1)
    keep = np.abs(1.0 - eta.astype(np.float64) ** 2 * (1.0 - cos_i ** 2)) > 0.03
    nrm, i, eta = nrm[keep], i[keep], eta[keep]
    d, ok = refract(torch.as_tensor(i), torch.as_tensor(nrm),
                    torch.as_tensor(eta))
    jd, jok = jrefract(jnp.asarray(i), jnp.asarray(nrm), jnp.asarray(eta))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert (~ok.numpy()).sum() > 20 and ok.numpy().sum() > 200
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), **HELPER_TOL)
    assert (d.numpy()[~ok.numpy()] == 0).all()


def test_ggx_half_vector_matches_jax():
    rng = np.random.default_rng(1)
    n = 500
    u1, u2 = (rng.random(n).astype(np.float32) for _ in range(2))
    nrm = _unit(rng, n)
    rough = rng.uniform(0.05, 1.0, n).astype(np.float32)
    h = ggx_sample_half_vector(*(torch.as_tensor(a) for a in
                                 (u1, u2, nrm, rough)))
    ref = jggx(*(jnp.asarray(a) for a in (u1, u2, nrm, rough)))
    np.testing.assert_allclose(h.numpy(), np.asarray(ref), **HELPER_TOL)
    assert (np.sum(h.numpy() * nrm, 1) >= -1e-6).all()


def test_pbr_brdf_and_pdf_match_jax():
    rng = np.random.default_rng(2)
    n = 500
    nrm = _unit(rng, n)
    wo, wi = _unit(rng, n), _unit(rng, n)
    wo = np.where((np.sum(wo * nrm, 1) < 0)[:, None], -wo, wo)
    alb = rng.random((n, 3)).astype(np.float32)
    metal = rng.random(n).astype(np.float32)
    rough = rng.uniform(0.0, 1.0, n).astype(np.float32)
    p_spec = np.clip(0.5 * metal + 0.1, 0.05, 0.95).astype(np.float32)
    t = [torch.as_tensor(a) for a in (nrm, wo, wi, alb, metal, rough)]
    j = [jnp.asarray(a) for a in (nrm, wo, wi, alb, metal, rough)]
    f = engine._pbr_brdf(*t).numpy()
    ref = np.asarray(jengine._pbr_brdf(*j))
    np.testing.assert_allclose(f, ref, atol=1e-6, rtol=2e-6)
    assert (f > 0).any() and (f == 0).any()
    pdf = engine._pbr_pdf(t[0], t[1], t[2], t[5], torch.as_tensor(p_spec))
    jpdf = jengine._pbr_pdf(j[0], j[1], j[2], j[5], jnp.asarray(p_spec))
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), atol=1e-6,
                               rtol=2e-6)


_SCENES = {
    "prims_glass": (lambda: jax_prims_scene(True), tb.prims_camera,
                    PRIMS_BARS),
    "prims": (lambda: jax_prims_scene(False), tb.prims_camera, PRIMS_BARS),
    "pbr_0.8_0.35": (lambda: jax_pbr_cornell(0.8, 0.35), tb.cornell_camera,
                     BARS),
    "pbr_0.0_0.9": (lambda: jax_pbr_cornell(0.0, 0.9), tb.cornell_camera,
                    BARS),
    "pbr_1.0_0.5": (lambda: jax_pbr_cornell(1.0, 0.5), tb.cornell_camera,
                    BARS),
    "mirror": (lambda: jax_pbr_cornell(1.0, 0.02), tb.cornell_camera, BARS),
}


@pytest.mark.parametrize("name", list(_SCENES))
def test_render_sample_matches_jax(name):
    """engine.render_sample against the XLA render_sample, 24², depth 3."""
    make, camera, bars = _SCENES[name]
    js = make()
    ts = torch_scene(js)
    assert ts.features == js.features and ts.prims.num == js.prims.num
    w = h = 24
    jcam = _jcam(camera(w, h))
    ref, ref_count = jengine.render_sample(js, jcam, w, h, 3, max_depth=3,
                                           chunk_size=None)
    out, count = engine.render_sample(ts, torch_cam(jcam), w, h, 3,
                                      max_depth=3)
    assert int(count) == int(float(ref_count))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **bars)
    assert float(out.max()) > 0.05


@pytest.mark.parametrize("name,spl", [("prims_glass", 2),
                                      ("pbr_0.8_0.35", 1)])
def test_fused_plain_matches_megakernel(name, spl):
    """render_sum_fused on CPU tensors (the plain version of kernel 3')
    against the Pallas megakernel in interpret mode, 16², depth 3."""
    make, camera, bars = _SCENES[name]
    js = make()
    ts = torch_scene(js)
    w = h = 16
    jcam = _jcam(camera(w, h))
    ref, ref_count = jfused(js, jcam, w, h, 4, samples_per_launch=spl,
                            max_depth=3, interpret=True)
    out, count = pallas_pt.render_sum_fused(ts, torch_cam(jcam), w, h,
                                            torch.tensor(4),
                                            samples_per_launch=spl,
                                            max_depth=3)
    assert int(count) == int(float(ref_count))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **bars)


def test_regen_gives_the_same_values():
    """The reference's path-regeneration schedule (regen=True, interpret
    mode) against the port's regen=True and regen=False on the prims +
    glass scene, 16², spl 2, depth 3: the port's per-thread loop is both
    schedules, so its two results are equal and agree with the
    reference's."""
    js = jax_prims_scene(True)
    ts = torch_scene(js)
    w = h = 16
    jcam = _jcam(tb.prims_camera(w, h))
    ref, ref_count = jfused(js, jcam, w, h, 9, samples_per_launch=2,
                            max_depth=3, interpret=True, regen=True)
    outs = [pallas_pt.render_sum_fused(ts, torch_cam(jcam), w, h, 9,
                                       samples_per_launch=2, max_depth=3,
                                       regen=regen) for regen in (True, False)]
    np.testing.assert_array_equal(outs[0][0].numpy(), outs[1][0].numpy())
    for out, count in outs:
        assert int(count) == int(float(ref_count))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   **PRIMS_BARS)


def _on_cuda(monkeypatch):
    """Make scenes report a CUDA device, to test the rule without a card
    (nothing launches)."""
    monkeypatch.setattr(DeviceScene, "device",
                        property(lambda self: torch.device("cuda")))


def _with_prims(scene, table):
    return dataclasses.replace(scene, prims=prim.make_prims(table, "cpu"))


@pytest.mark.parametrize("case,expected", [
    ("prims_glass", True), ("pbr", True), ("mirror", True),
    ("cornell", True), ("17_prims", False), ("swept", False),
    ("cutouts", False), ("129_materials", False)])
def test_use_fused_rule(monkeypatch, case, expected):
    """engine._use_fused mirrors the reference's rule (engine.py:772-821)
    minus its TPU test: on a CUDA device the fused kernel takes scenes of
    at most 16 prims of kinds 0-3, 128 materials and glass / mirror / pbr
    materials; more prims or materials, a swept prim or cutouts go to the
    wavefront."""
    scene = {"prims_glass": lambda: tb.prims_scene("cpu"),
             "pbr": lambda: tb.pbr_cornell("cpu"),
             "mirror": lambda: tb.pbr_cornell("cpu", 1.0, 0.02),
             "cornell": lambda: tb.cornell_box("cpu"),
             "17_prims": lambda: _with_prims(
                 tb.prims_scene("cpu"), (tb.prims_list() * 5)[:17]),
             "swept": lambda: _with_prims(tb.prims_scene("cpu"), [
                 {"kind": prim.SWEPT_CUBIC, "a0": (0, 0, 0),
                  "a1": (1, 0, 0), "a2": (0, 1, 0), "a3": (0, 0, 1),
                  "r": (0.1, 0, 0, 0)}]),
             "cutouts": lambda: dataclasses.replace(
                 tb.prims_scene("cpu"), features=("glass", "cutouts")),
             "129_materials": lambda: make_device_scene(
                 *tb.prims_floor(), np.array([0, 128], np.int32),
                 [{"kind": M.DIFFUSE}] * 129, "cpu"),
             }[case]()
    assert not engine._use_fused(scene, "auto")      # CPU: the wavefront
    _on_cuda(monkeypatch)
    assert engine._use_fused(scene, "auto") is expected
    assert engine._use_fused(scene, "fused") and not engine._use_fused(
        scene, "wavefront")


def test_fused_auto_matches_wavefront_on_cpu():
    """On the CPU, impl="fused" (the plain version) and impl="wavefront"
    give the same film on the prims + glass and PBR scenes."""
    from optix_raytracer_tpu_torch.core.film import Film
    for scene, cam in ((tb.prims_scene("cpu"), tb.prims_camera(8, 6)),
                       (tb.pbr_cornell("cpu"), tb.cornell_camera(8, 6))):
        films = [engine.render_accumulate(scene, cam.params("cpu"),
                                          Film.create(6, 8, "cpu"), 8, 6,
                                          samples_per_launch=2, max_depth=3,
                                          impl=impl)
                 for impl in ("fused", "wavefront")]
        np.testing.assert_array_equal(films[0][0].accum.numpy(),
                                      films[1][0].accum.numpy())
        assert int(films[0][1]) == int(films[1][1]) > 48
