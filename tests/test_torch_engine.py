"""The port's wavefront engine and the plain version of the fused kernel
against the JAX engine and the Pallas megakernel (interpret mode) on the
CPU, at small sizes. Both sides draw the same RNG streams, so traced-ray
counts must be equal and radiance agree within atol 2e-3 / rtol 1e-3
(test_fused_kernel.py's bars: f32 reassociation noise)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_raytracer_tpu.core import film as jfilm
from optix_raytracer_tpu.scene.builtins import cornell_box as jcornell
from optix_raytracer_tpu.scene.builtins import cornell_camera as jcamera
from optix_raytracer_tpu.wavefront import engine as jengine
from optix_raytracer_tpu.wavefront.pallas_pt import render_sum_fused as jfused
from optix_raytracer_tpu_torch.apps import pathtracer
from optix_raytracer_tpu_torch.core.film import Film
from optix_raytracer_tpu_torch.scene.builtins import cornell_box, cornell_camera
from optix_raytracer_tpu_torch.wavefront import engine
from optix_raytracer_tpu_torch.wavefront.pallas_pt import render_sum_fused

from torch_parity import torch_cam, torch_scene

ATOL, RTOL = 2e-3, 1e-3


@pytest.fixture(scope="module")
def scenes():
    js = jcornell()
    return js, torch_scene(js)


def test_render_sample_matches_jax(scenes):
    js, ts = scenes
    w = h = 16
    jcam = jcamera(w, h).params()
    tcam = torch_cam(jcam)
    for subframe in (0, 1):
        ref, ref_count = jengine.render_sample(js, jcam, w, h, subframe,
                                               max_depth=2, chunk_size=None)
        out, count = engine.render_sample(ts, tcam, w, h, subframe,
                                          max_depth=2)
        assert count.dtype == torch.int64
        assert int(count) == int(float(ref_count))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=ATOL, rtol=RTOL)


def test_fused_plain_matches_jax_megakernel(scenes):
    """render_sum_fused on CPU tensors (the plain version of kernel 3) vs
    the Pallas megakernel in interpret mode, 16², spl 2, depth 2."""
    js, ts = scenes
    w = h = 16
    jcam = jcamera(w, h).params()
    ref, ref_count = jfused(js, jcam, w, h, 3, samples_per_launch=2,
                            max_depth=2, interpret=True)
    out, count = render_sum_fused(ts, torch_cam(jcam), w, h,
                                  torch.tensor(3), samples_per_launch=2,
                                  max_depth=2)
    assert int(count) == int(float(ref_count))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_render_accumulate_film_matches_jax(scenes):
    """Two progressive launches with variance tracking: the same film
    (accum, sq, subframe, launches) as the JAX render_accumulate."""
    js, ts = scenes
    w = h = 8
    jcam = jcamera(w, h).params()
    tcam = torch_cam(jcam)
    jf = jfilm.Film.create(h, w, track_variance=True)
    tf = Film.create(h, w, "cpu", track_variance=True)
    for _ in range(2):
        jf, jrays = jengine.render_accumulate(js, jcam, jf, w, h,
                                              samples_per_launch=2,
                                              max_depth=2, chunk_size=None,
                                              impl="xla")
        tf, trays = engine.render_accumulate(ts, tcam, tf, w, h,
                                             samples_per_launch=2,
                                             max_depth=2, impl="auto")
        assert int(trays) == int(float(jrays))
    assert int(tf.subframe) == int(jf.subframe) == 4
    assert int(tf.launches) == int(jf.launches) == 2
    np.testing.assert_allclose(tf.accum.numpy(), np.asarray(jf.accum),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tf.sq.numpy(), np.asarray(jf.sq),
                               atol=ATOL, rtol=RTOL)


def test_merge_launch_matches_jax():
    """The film math alone, on identical inputs, to f32 rounding."""
    rng = np.random.default_rng(9)
    accum = rng.uniform(0, 2, (5, 6, 3)).astype(np.float32)
    sq = rng.uniform(0, 4, (5, 6, 3)).astype(np.float32)
    rad_sum = rng.uniform(0, 30, (5, 6, 3)).astype(np.float32)
    jf = jfilm.Film(accum=jnp.asarray(accum), subframe=jnp.int32(48),
                    sq=jnp.asarray(sq), launches=jnp.int32(3))
    tf = Film(accum=torch.as_tensor(accum), subframe=torch.tensor(48),
              sq=torch.as_tensor(sq), launches=torch.tensor(3))
    jout = jengine._merge_launch(jf, jnp.asarray(rad_sum), 16)
    tout = engine._merge_launch(tf, torch.as_tensor(rad_sum), 16)
    np.testing.assert_allclose(tout.accum.numpy(), np.asarray(jout.accum),
                               rtol=1e-6)
    np.testing.assert_allclose(tout.sq.numpy(), np.asarray(jout.sq),
                               rtol=1e-6)
    assert int(tout.subframe) == 64 and int(tout.launches) == 4


def test_golden_cornell():
    """The port reproduces tests/golden/cornell_32x32_64spp.npz within
    test_golden.py's RMSE 3e-3 (32², 64 spp, depth 3)."""
    path = os.path.join(os.path.dirname(__file__), "golden",
                        "cornell_32x32_64spp.npz")
    with np.load(path) as z:
        golden = z["image"]
    film, rays = engine.render_accumulate(
        cornell_box("cpu"), cornell_camera(32, 32).params("cpu"),
        Film.create(32, 32, "cpu"), 32, 32, samples_per_launch=64,
        max_depth=3)
    rmse = float(np.sqrt(np.mean((film.accum.numpy() - golden) ** 2)))
    assert rmse < 3e-3, rmse
    assert int(film.subframe) == 64 and int(rays) > 32 * 32 * 64


def test_matches_numpy_oracle():
    """test_pathtracer.py's statistical check, for the port: 32², 160 spp,
    depth 3 against the independent numpy integrator (mean abs diff < 0.03,
    energy within 5%)."""
    from oracle_pt import render_oracle, scene_to_numpy
    w = h = 32
    film, _ = engine.render_accumulate(
        cornell_box("cpu"), cornell_camera(w, h).params("cpu"),
        Film.create(h, w, "cpu"), w, h, samples_per_launch=160, max_depth=3)
    img = film.accum.numpy()
    cam = {k: np.asarray(v) for k, v in jcamera(w, h).params().items()}
    ref = render_oracle(scene_to_numpy(jcornell()), cam, w, h, samples=160,
                        max_depth=3, seed=3)
    assert np.abs(img - ref).mean() < 0.03
    assert abs(img.mean() - ref.mean()) / ref.mean() < 0.05


def test_row_tiles_reproduce_full_frame():
    """Two half-height launches with y0 give the full frame's rows (the
    row-tile contract of test_fused_kernel.py), and their counts add up."""
    ts = cornell_box("cpu")
    w, h = 12, 12
    cam = cornell_camera(w, h).params("cpu")
    full, c_full = render_sum_fused(ts, cam, w, h, 5, samples_per_launch=1,
                                    max_depth=2)
    top, c_top = render_sum_fused(ts, cam, w, 6, 5, samples_per_launch=1,
                                  max_depth=2, y0=0, full_width=w,
                                  full_height=h)
    bot, c_bot = render_sum_fused(ts, cam, w, 6, 5, samples_per_launch=1,
                                  max_depth=2, y0=6, full_width=w,
                                  full_height=h)
    np.testing.assert_array_equal(top.numpy(), full[:6].numpy())
    np.testing.assert_array_equal(bot.numpy(), full[6:].numpy())
    assert int(c_top) + int(c_bot) == int(c_full)


def test_impl_dispatch():
    ts = cornell_box("cpu")
    assert not engine._use_fused(ts, "auto")      # the kernel needs CUDA
    assert engine._use_fused(ts, "fused")
    assert not engine._use_fused(ts, "wavefront")
    with pytest.raises(ValueError):
        engine._use_fused(ts, "xla")
    cam = cornell_camera(6, 4).params("cpu")
    a, ca = engine.render_accumulate(ts, cam, Film.create(4, 6, "cpu"), 6, 4,
                                     samples_per_launch=2, max_depth=2,
                                     impl="fused")
    b, cb = engine.render_accumulate(ts, cam, Film.create(4, 6, "cpu"), 6, 4,
                                     samples_per_launch=2, max_depth=2,
                                     impl="wavefront")
    np.testing.assert_array_equal(a.accum.numpy(), b.accum.numpy())
    assert int(ca) == int(cb)


def test_pathtracer_cli_writes_image(tmp_path):
    out = tmp_path / "cornell.ppm"
    pathtracer.main(["--file", str(out), "--dim", "8x6", "--samples", "2",
                     "--launch-samples", "1", "--depth", "2",
                     "--device", "cpu"])
    from optix_raytracer_tpu.io.image import load_image
    img = load_image(str(out))
    assert img.shape == (6, 8, 3) and img.dtype == np.uint8
    with pytest.raises(SystemExit):
        pathtracer.parse_dim("bogus")
