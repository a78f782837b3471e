"""The port's alpha cutouts end to end (the wavefront's cut lanes, the
cutouts, opacity-micromap and displaced-micromesh apps, the Whitted
integrator's textured lane, the fused kernel's refusal) against the JAX
package on the CPU.

Bars: ray counts equal, radiance within atol 2e-3 / rtol 1e-3
(tests/test_fused_kernel.py); the micromap statistics equal. The port
renders the JAX scene handed over (torch_parity.scene_fields) with the JAX
camera handed over, except where a test says it builds its own; JAX renders
through its jitted engine, whose FMA contractions move a value by an ulp,
inside the bars. The cutout grid (2,402 triangles) is a cluster scene to
the port (the plain walks here) and brute force to JAX on the CPU. About 80
s on one worker, most of it JAX compiles (one per scene and frame).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_raytracer_tpu.apps import cutouts as jcutouts
from optix_raytracer_tpu.apps import displaced_micromesh as jdmm
from optix_raytracer_tpu.apps import opacity_micromap as jomm
from optix_raytracer_tpu.core.camera import Camera as JCamera
from optix_raytracer_tpu.core.film import Film as JFilm
from optix_raytracer_tpu.scene import builtins as jbuiltins
from optix_raytracer_tpu.wavefront import engine as jengine
from optix_raytracer_tpu.wavefront import whitted as jwhitted
from optix_raytracer_tpu_torch.apps import cutouts as tcutouts
from optix_raytracer_tpu_torch.apps import displaced_micromesh as tdmm
from optix_raytracer_tpu_torch.apps import opacity_micromap as tomm
from optix_raytracer_tpu_torch.core.film import Film
from optix_raytracer_tpu_torch.scene import builtins as tb
from optix_raytracer_tpu_torch.scene.device_scene import make_device_scene
from optix_raytracer_tpu_torch.shade import materials as tmats
from optix_raytracer_tpu_torch.wavefront import engine
from optix_raytracer_tpu_torch.wavefront import whitted as twhitted

from test_torch_micromap import jax_scene
from torch_parity import one_torch_thread, torch_cam, torch_scene  # noqa: F401

ATOL, RTOL = 2e-3, 1e-3


def _close(out, ref, what):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape and np.isfinite(out).all(), what
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL, err_msg=what)


def _pt_pair(jscene, jcam, w, h, spl, depth, subframe=0, **kw):
    """One render_accumulate launch of both packages on the same scene and
    camera bits → (port film accum, JAX film accum, port rays, JAX
    rays)."""
    jfilm = JFilm.create(h, w)
    jfilm = jfilm.replace(subframe=jnp.asarray(subframe, jfilm.subframe.dtype))
    jf, jr = jengine.render_accumulate(jscene, jcam, jfilm, w, h,
                                       samples_per_launch=spl,
                                       max_depth=depth)
    film = Film.create(h, w, "cpu")
    film.subframe = torch.tensor(subframe, dtype=torch.int64)
    tf, tr = engine.render_accumulate(torch_scene(jscene), torch_cam(jcam),
                                      film, w, h, samples_per_launch=spl,
                                      max_depth=depth, **kw)
    return tf.accum.numpy(), np.asarray(jf.accum), int(tr), int(jr)


def test_cutouts_app_matches_jax():
    """The cutouts app at 24x24, 2 samples, depth 4: the app's own scene
    and camera on each side (the geometry of the two builds rounds apart in
    the last bit: the images agree within the bars, the ray counts
    exactly), and the JAX scene handed over; both show holes (fewer hits
    on the blocks than without micromaps' cut lanes would give)."""
    w = h = 24
    img, film, rays = tcutouts.render(w, h, samples=2, max_depth=4,
                                      device="cpu")
    ref, jfilm = jcutouts.render(w, h, samples=2, max_depth=4)
    _close(img.numpy(), ref, "cutouts app")
    assert int(film.subframe) == int(jfilm.subframe) == 2
    out, ref2, n, jn = _pt_pair(jcutouts.cutout_cornell(),
                                jbuiltins.cornell_camera(w, h).params(),
                                w, h, 2, 4)
    _close(out, ref2, "cutout Cornell handed over")
    assert n == jn and n > w * h * 2
    np.testing.assert_allclose(out, img.numpy(), atol=ATOL, rtol=RTOL)
    assert int(rays) == n


def test_cut_lanes_pass_through():
    """A ray into a hole passes on: at depth 1 the cut lane spends the
    bounce passing (no shade, no shadow ray), so the cut box traces fewer
    rays than the plain Cornell box and shows black where the plain box
    shows a lit block; at depth 3, opacity_micromaps=False renders the same
    image with the same rays (the mask alone decides)."""
    w = h = 16
    cam = tb.cornell_camera(w, h).params("cpu")

    def run(scene, depth):
        f, r = engine.render_accumulate(scene, cam, Film.create(h, w, "cpu"),
                                        w, h, samples_per_launch=2,
                                        max_depth=depth)
        return f.accum.numpy(), int(r)

    cut, n_cut = run(tcutouts.cutout_cornell("cpu"), 1)
    plain, n_plain = run(tb.cornell_box("cpu"), 1)
    assert n_cut < n_plain
    holes = (cut.sum(axis=-1) == 0) & (plain.sum(axis=-1) > 0)
    assert holes.sum() > 4 and holes[:4].sum() == 0
    omm, n_omm = run(tcutouts.cutout_cornell("cpu"), 3)
    mask, n_mask = run(tcutouts.cutout_cornell("cpu",
                                               opacity_micromaps=False), 3)
    assert n_omm == n_mask
    np.testing.assert_allclose(omm, mask, atol=ATOL, rtol=RTOL)


def test_omm_app_matches_jax():
    """The opacity-micromap app at 24x24, 2 samples (its depth 3): the
    image and its classification statistics (the micromap at level 3 and 2,
    and the fractions) equal the JAX app's."""
    w = h = 24
    for level in (3, 2):
        img, stats, rays = tomm.render(w, h, samples=2, level=level,
                                       device="cpu")
        ref, jstats = jomm.render(w, h, samples=2, level=level)
        for key in ("micro_states", "tri_summary"):
            np.testing.assert_array_equal(stats[key], jstats[key])
        for key in ("fully_classified_fraction", "opaque_fraction",
                    "transparent_fraction"):
            assert stats[key] == jstats[key], key
        _close(img.numpy(), ref, "omm app")
        assert int(rays) > w * h * 2


@pytest.mark.parametrize("impl", ["auto", "wavefront"])
def test_cutout_grid_matches_jax(impl):
    """The cutout grid (every summary certain: the radiance side reads the
    summary alone) at 16x16, 8 samples a launch, depth 3: "auto" takes the
    port's sample-major path (a cluster scene at spl 8), "wavefront" its
    sequential, coherence-sorted one; JAX takes its own sample-major path
    (brute force on the CPU)."""
    w = h = 16
    js = jax_scene(tb.cutout_grid_parts())
    assert js.omm_all_certain and js.has_clusters
    cam = tb.cutout_grid_camera(w, h)
    jcam = JCamera(eye=cam.eye, lookat=cam.lookat, up=cam.up,
                   fov_y=cam.fov_y, aspect=cam.aspect).params()
    out, ref, n, jn = _pt_pair(js, jcam, w, h, 8, 3, subframe=3, impl=impl)
    _close(out, ref, f"cutout grid {impl}")
    assert n == jn and out.mean() > 0


def test_textured_cutout_matches_jax():
    """The textured cutout Cornell (a CUT_TEXTURE tall block: the radiance
    side reads the bundle's base alpha, shadow rays the atlas's level 0,
    the micromap the nearest texel), 16x16, 2 samples, depth 3."""
    w = h = 16
    js = jax_scene(tb.textured_cutout_cornell_parts())
    assert js.has_textures and not js.omm_all_certain
    out, ref, n, jn = _pt_pair(js, jbuiltins.cornell_camera(w, h).params(),
                               w, h, 2, 3, subframe=1)
    _close(out, ref, "textured cutout")
    assert n == jn


def test_textured_whitted_matches_jax():
    """The textured Whitted scene (a textured floor and a CUT_TEXTURE phong
    quad: the textured lane's shading normal and base map, the shadow
    rays' alpha loop over the unknown split) at 32x24, depth 3, two
    subframes."""
    w, h = 32, 24
    parts = tb.textured_whitted_parts()
    js = jax_scene(parts, lights=tb.TEXTURED_WHITTED_LIGHTS,
                   miss_color=(0.3, 0.45, 0.7))
    ts = torch_scene(js)
    assert ts.has_textures and ts.has_omm and ts.lights.num == 2
    jcam = JCamera(**{k: getattr(tb.textured_whitted_camera(w, h), k)
                      for k in ("eye", "lookat", "up", "fov_y",
                                "aspect")}).params()
    for sub in (0, 1):
        ref = jwhitted.render_whitted_sample(js, jcam, w, h, jnp.uint32(sub),
                                             max_depth=3)
        img, rays = twhitted.render_whitted_sample(ts, torch_cam(jcam), w, h,
                                                   sub, max_depth=3)
        _close(img.numpy(), ref, f"textured whitted {sub}")
        assert int(rays) > w * h
    own, _ = twhitted.render_whitted_sample(
        tb.textured_whitted_scene("cpu"),
        tb.textured_whitted_camera(w, h).params("cpu"), w, h, 1,
        max_depth=3)
    _close(own.numpy(), ref, "textured whitted, the port's own build")


@pytest.mark.parametrize("level", [3, 4])
def test_displaced_micromesh_app_matches_jax(level):
    """The displaced-micromesh app at 24x24, 1 sample: level 3 (128
    triangles) and level 4 (512, the app's default, still brute force)."""
    w = h = 24
    img, n_tris, rays = tdmm.render(w, h, level=level, samples=1,
                                    device="cpu")
    ref, jn_tris = jdmm.render(w, h, level=level, samples=1)
    assert n_tris == jn_tris == 2 * 4 ** level
    _close(img.numpy(), ref, f"micromesh level {level}")
    assert int(rays) > w * h


def test_fused_and_motion_raise():
    """impl="fused" on a cutout scene raises (the fused kernel has no cut
    lane), on the CPU as on the card; "auto" takes the wavefront. A motion
    scene builds now (ROADMAP.md Queue 1 item 9 is ported), and the fused
    kernel refuses it the same way (no shutter times in the kernel)."""
    scene = tcutouts.cutout_cornell("cpu")
    cam = tb.cornell_camera(8, 8).params("cpu")
    with pytest.raises(NotImplementedError, match="cutouts"):
        engine.render_accumulate(scene, cam, Film.create(8, 8, "cpu"), 8, 8,
                                 impl="fused")
    assert not engine._use_fused(dataclasses.replace(scene), "auto")
    verts, idx, tri_mat = tb.quads_to_triangles(tb._CORNELL_QUADS)
    moving = make_device_scene(verts, idx, tri_mat, tb.CORNELL_MATERIALS,
                               "cpu", motion={"verts0": verts,
                                              "verts1": verts,
                                              "indices": idx})
    assert moving.has_motion and moving.motion_tri_mat.tolist() == [0] * 32
    with pytest.raises(NotImplementedError, match="moving triangles"):
        engine.render_accumulate(moving, cam, Film.create(8, 8, "cpu"), 8, 8,
                                 impl="fused")
    assert not engine._use_fused(dataclasses.replace(moving), "auto")
    assert tmats.CUT_TEXTURE == 3
