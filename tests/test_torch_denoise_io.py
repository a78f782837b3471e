"""What the port's denoiser reads and writes, against the JAX package on the
CPU: the film's variance and reset, `render_aovs` (the guide layers), the
EXR codec both ways, image I/O, and the denoiser, optical-flow and
`pathtracer --denoise` apps at 16x16 on `--device cpu`, their inputs
written in-process.

Bars: the AOV layers with the same hit / miss mask; from the same hits
within 1e-5 (the smooth knot's normals within tests/test_torch_smooth.py's
shading-frame bar, 1e-6), from each package's own hits within the looser
bars of OWN_HITS_TOL (the measured maxima beside them); the film bit-equal; the EXR round trips equal; the apps'
denoised outputs within atol 1e-4 / rtol 1e-3 (written as .npz, which
keeps float32) and their flows equal. About 55 s on one worker with a cold
JAX compile cache (the eager reference render_aovs about 8 s a scene).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_raytracer_tpu.apps import denoiser as jdenoiser_app
from optix_raytracer_tpu.apps import optical_flow as jflow_app
from optix_raytracer_tpu.core import camera as jcamera
from optix_raytracer_tpu.core import film as jfilm
from optix_raytracer_tpu.io import exr as jexr
from optix_raytracer_tpu.scene import builtins as jb
from optix_raytracer_tpu.scene.device_scene import make_device_scene
from optix_raytracer_tpu.wavefront import engine as jengine
from optix_raytracer_tpu.wavefront import intersect as jintersect
from optix_raytracer_tpu_torch.api.denoiser import Denoiser
from optix_raytracer_tpu_torch.apps import denoiser as tdenoiser_app
from optix_raytracer_tpu_torch.apps import optical_flow as tflow_app
from optix_raytracer_tpu_torch.apps import pathtracer as tpathtracer
from optix_raytracer_tpu_torch.core import camera as tcamera
from optix_raytracer_tpu_torch.core import film as tfilm
from optix_raytracer_tpu_torch.core.rays import Hits
from optix_raytracer_tpu_torch.io import exr as texr
from optix_raytracer_tpu_torch.io.image import load_image, save_image
from optix_raytracer_tpu_torch.scene import builtins as tb
from optix_raytracer_tpu_torch.wavefront import engine as tengine
from optix_raytracer_tpu_torch.wavefront import intersect as tintersect

import test_exr as jexr_tests
from torch_parity import one_torch_thread, torch_cam, torch_scene  # noqa: F401

ATOL, RTOL = 1e-4, 1e-3


def test_film_variance_and_reset():
    rng = np.random.default_rng(0)
    jf = jfilm.Film.create(6, 5, track_variance=True)
    tf = tfilm.Film.create(6, 5, "cpu", track_variance=True)
    assert tf.variance_of_mean() is not None
    for _ in range(3):
        r = rng.gamma(1.0, 0.5, (6, 5, 3)).astype(np.float32)
        jf = jf.accumulate(jnp.asarray(r))
        tf = tf.accumulate(torch.as_tensor(r))
    for k in ("accum", "sq"):
        np.testing.assert_array_equal(getattr(tf, k).numpy(),
                                      np.asarray(getattr(jf, k)))
    np.testing.assert_array_equal(tf.variance_of_mean().numpy(),
                                  np.asarray(jf.variance_of_mean()))
    z = tf.reset()
    for k in ("accum", "subframe", "sq", "launches"):
        a, b = getattr(z, k), getattr(tf, k)
        assert a.dtype == b.dtype and a.device == b.device
        assert a.shape == b.shape and not a.any()
    plain = tfilm.Film.create(4, 4, "cpu").accumulate(torch.ones(4, 4, 3))
    assert plain.variance_of_mean() is None
    assert plain.reset().sq is None and plain.reset().launches is None
    c = np.linspace(-0.1, 1.1, 97, dtype=np.float32)
    np.testing.assert_allclose(
        tfilm.srgb_to_linear(torch.as_tensor(c)).numpy(),
        np.asarray(jfilm.srgb_to_linear(jnp.asarray(c))), rtol=1e-6,
        atol=1e-7)


def _textured():
    parts = tb.textured_whitted_parts()
    verts, idx, tri_mat, materials, uvs, textures, _ = parts
    cam = tb.textured_whitted_camera(16, 16)
    return (make_device_scene(verts, idx, tri_mat, materials, uvs=uvs,
                              textures=textures),
            jcamera.Camera(eye=cam.eye, lookat=cam.lookat, up=cam.up,
                           fov_y=cam.fov_y, aspect=cam.aspect).params())


AOV_SCENES = {
    "cornell": lambda: (jb.cornell_box(), jb.cornell_camera(16, 16).params()),
    "textured": _textured,
    "smooth_knot": lambda: (jb.knot_scene(8, 6),
                            jb.knot_camera(16, 16).params()),
    "instanced": lambda: (jb.cornell_box_instanced(),
                          jb.cornell_camera(16, 16).params()),
}


# The layers from each package's own hits: the port's brute force and the
# reference's place barycentrics up to 5.7e-6 apart (t 2.9e-6), which
# moves an interpolated normal by up to 7.6e-6 on the smooth knot and a
# texel lookup by up to 2.0e-5 of albedo on the textured scene's 64-texel
# map tiled 4x (the measured maxima).
OWN_HITS_TOL = {"smooth_knot": 2e-5, "textured": 5e-5}


@pytest.mark.parametrize("name", list(AOV_SCENES))
def test_render_aovs(name, monkeypatch):
    """The guide layers: the same hit / miss mask; from the same hits (the
    reference's, handed to the port's render_aovs) within 1e-5, the smooth
    knot's normals within 1e-6; from each package's own hits within
    OWN_HITS_TOL where the scene interpolates."""
    js, jcam = AOV_SCENES[name]()
    ts, tcam = torch_scene(js), torch_cam(jcam)
    assert {"textured": ts.has_textures, "smooth_knot": ts.geom.smooth,
            "instanced": ts.has_instances}.get(name, True)
    # eager: XLA's FMAs inside jit would move the reference's uv by ulps
    with jax.disable_jit():
        ref = jengine.render_aovs(js, jcam, 16, 16)
        jr, _ = jcamera.generate_rays(jcam, 16, 16, jitter=False)
        jr = jax.tree.map(lambda a: a.reshape((256,) + a.shape[2:]), jr)
        jh = jintersect.scene_closest(js, jr)
    tr, _ = tcamera.generate_rays(tcam, 16, 16, jitter=False)
    th = tintersect.scene_closest(ts, tr.reshape(256))
    hit = np.asarray(jh.prim_id) >= 0
    np.testing.assert_array_equal(th.valid.numpy(), hit)
    assert hit.any() and (name in ("cornell", "instanced") or not hit.all())
    own = tengine.render_aovs(ts, tcam, 16, 16)
    same_hits = Hits(**{f: torch.as_tensor(np.array(getattr(jh, f)))
                        for f in ("t", "prim_id", "inst_id", "mat_id", "uv",
                                  "normal")})
    monkeypatch.setattr(tengine, "scene_closest",
                        lambda scene, rays, chunk_size=None: same_hits)
    out = tengine.render_aovs(ts, tcam, 16, 16)
    hit = hit.reshape(16, 16)
    for k in ("albedo", "normal", "emission"):
        a, b = out[k].numpy(), np.asarray(ref[k])
        if k == "albedo" and name == "textured":
            # the reference scales a miss's albedo 1 by a texel fetched at
            # the barycentrics its brute force leaves in the missed ray's
            # record (engine.py:941-952); the port keeps 1
            assert (a[~hit] == 1.0).all() and (own[k].numpy()[~hit]
                                               == 1.0).all()
            a, b = a[hit], b[hit]
        tol = 1e-6 if (k == "normal" and name == "smooth_knot") else 1e-5
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol, err_msg=k)
        a = own[k].numpy()
        if k == "albedo" and name == "textured":
            a = a[hit]
        tol = OWN_HITS_TOL.get(name, 1e-5)
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol, err_msg=k)
    if name == "textured":
        assert float(out["albedo"].std()) > 0.05


@pytest.mark.parametrize("pixel_type", ["HALF", "FLOAT"])
@pytest.mark.parametrize("compression", ["NONE", "ZIPS", "ZIP", "PIZ"])
def test_exr_both_ways(pixel_type, compression, tmp_path):
    """The port's writer read by the JAX package's reader and the reverse,
    equal; and equal files from both writers."""
    img = np.random.default_rng(1).uniform(
        -2, 6, (19, 23, 4)).astype(np.float32)
    a, b = str(tmp_path / "a.exr"), str(tmp_path / "b.exr")
    texr.write_exr(a, img, pixel_type=pixel_type, compression=compression)
    jexr.write_exr(b, img, pixel_type=pixel_type, compression=compression)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    np.testing.assert_array_equal(jexr.read_exr(a), texr.read_exr(b))
    np.testing.assert_array_equal(texr.read_exr(a), jexr.read_exr(a))
    if pixel_type == "FLOAT":
        np.testing.assert_array_equal(texr.read_exr(a), img)


def test_exr_multipart_and_tiled(tmp_path):
    rng = np.random.default_rng(2)
    beauty = rng.uniform(0, 4, (13, 9, 3)).astype(np.float32)
    depth = rng.uniform(0, 9, (13, 9)).astype(np.float32)
    parts = [("beauty", beauty, {"compression": "PIZ"}),
             ("depth", depth, {"pixel_type": "FLOAT", "channels": ("Z",)})]
    for i, (writer, reader) in enumerate(((texr, jexr), (jexr, texr))):
        p = str(tmp_path / f"mp{i}.exr")
        writer.write_exr_multipart(p, parts)
        assert reader.read_exr_parts(p) == ["beauty", "depth"]
        for part in (0, "depth"):
            np.testing.assert_array_equal(
                reader.read_exr(p, part=part),
                writer.read_exr(p, part=part))
    img = rng.uniform(0, 4, (23, 31, 3)).astype(np.float32)
    for comp in ("NONE", "ZIP", "PIZ"):
        p = str(tmp_path / f"t_{comp}.exr")
        jexr_tests.TestTiledRead._write_tiled(p, img, tile=(7, 5),
                                              compression=comp)
        np.testing.assert_array_equal(texr.read_exr(p), jexr.read_exr(p))
        np.testing.assert_allclose(texr.read_exr(p), img, atol=1e-6)


def test_image_io(tmp_path):
    """Float pixels are sRGB-encoded into .ppm / .png as the reference's
    writer does, kept raw in .exr / .npz, and read back."""
    from optix_raytracer_tpu.io import image as jimage
    rng = np.random.default_rng(3)
    f = rng.uniform(-0.1, 1.2, (7, 9, 3)).astype(np.float32)
    u8 = rng.integers(0, 256, (7, 9, 3)).astype(np.uint8)
    for ext in (".ppm", ".png", ".exr", ".npz"):
        for img in (f, u8):
            mine = str(tmp_path / f"m{img.dtype}{ext}")
            ref = str(tmp_path / f"r{img.dtype}{ext}")
            save_image(mine, img)
            jimage.save_image(ref, img)
            np.testing.assert_array_equal(load_image(mine),
                                          jimage.load_image(ref))
    np.testing.assert_array_equal(load_image(str(tmp_path / "mfloat32.npz")),
                                  f)


def _write(path, img):
    save_image(path, img.astype(np.float32))
    return path


@pytest.fixture(scope="module")
def app_inputs(tmp_path_factory):
    """16x16 float layers (beauty frames 0-2, albedo, normal, flow, trust,
    an AOV, a low-res beauty) as .npz files."""
    d = tmp_path_factory.mktemp("layers")
    rng = np.random.default_rng(4)
    y, x = np.mgrid[0:16, 0:16].astype(np.float32)
    base = np.stack([np.sin(x / 3), np.cos(y / 4), np.sin((x + y) / 5)],
                    -1) * 0.4 + 0.6
    paths = {}
    for f in range(3):
        noisy = np.roll(base, f, 1) + rng.normal(0, 0.2, base.shape)
        paths[f"b{f}"] = _write(str(d / f"b-{f:02d}.npz"),
                                np.maximum(noisy, 0))
    paths["b"] = str(d / "b-++.npz")
    n = rng.normal(size=(16, 16, 3))
    for k, v in dict(albedo=rng.uniform(0.2, 1, (16, 16, 3)),
                     normal=n / np.linalg.norm(n, axis=-1, keepdims=True),
                     flow=rng.normal(0, 1.5, (16, 16, 3)),
                     trust=rng.uniform(size=(16, 16, 3)),
                     aov=rng.gamma(1.0, 0.3, (16, 16, 3)),
                     low=rng.gamma(1.0, 0.5, (8, 8, 3))).items():
        paths[k] = _write(str(d / f"{k}.npz"), v)
    return paths


APP_CASES = {
    "hdr": lambda p: [p["b0"], "-a", p["albedo"], "-n", p["normal"]],
    "ldr_blend_exposure": lambda p: [p["b0"], "--ldr", "-b", "0.25", "-e",
                                     "0.5"],
    "tiled": lambda p: [p["b0"], "-a", p["albedo"], "-t", "8", "-i", "2"],
    "aov": lambda p: [p["b0"], "-a", p["albedo"], "-A", p["aov"], "-S",
                      p["trust"]],
    "temporal": lambda p: [p["b1"], "-p", p["b0"], "-F", p["flow"], "-T",
                           p["trust"], "-a", p["albedo"]],
    "upscale": lambda p: [p["low"], "--upscale", "-a", p["albedo"], "-n",
                          p["normal"]],
    "flow_apply": lambda p: [p["b0"], "-z", "-F", p["flow"]],
    "frames": lambda p: [p["b"], "--Frames", "0-2", "-a", p["albedo"]],
}


@pytest.mark.parametrize("case", list(APP_CASES))
def test_denoiser_app(case, app_inputs, tmp_path, capsys):
    """The optixDenoiser CLI: the port's outputs (and AOV outputs, and
    every frame of a sequence) against the JAX app's on the same files."""
    args = APP_CASES[case](app_inputs)
    frames = case == "frames"
    outs = {}
    for name, main, extra in (("j", jdenoiser_app.main, []),
                              ("t", tdenoiser_app.main,
                               ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        main(args + ["-o", str(d / ("o-++.npz" if frames else "o.npz"))]
             + extra)
        outs[name] = {f: load_image(str(d / f)) for f in os.listdir(d)}
    assert capsys.readouterr().out.count("wrote") == (6 if frames else 2)
    assert sorted(outs["t"]) == sorted(outs["j"])
    assert len(outs["t"]) == {"frames": 3, "aov": 3}.get(case, 1)
    for f, ref in outs["j"].items():
        np.testing.assert_allclose(outs["t"][f], ref, atol=ATOL, rtol=RTOL,
                                   err_msg=f)
    assert tdenoiser_app.frame_filename("b-++++.exr", 7) == "b-0007.exr"
    with pytest.raises(ValueError):
        tdenoiser_app.frame_filename("b-++.exr", 1234)


def test_optical_flow_app(app_inputs, tmp_path, capsys):
    """The optixOpticalFlow CLI, a pair and a --Frames sequence: flows
    (x, y, 0) equal to the JAX app's."""
    p = app_inputs
    for name, main, extra in (("j", jflow_app.main, []),
                              ("t", tflow_app.main, ["--device", "cpu"])):
        main([p["b0"], p["b1"], "-o", str(tmp_path / f"{name}.npz"),
              "--levels", "2"] + extra)
        main([p["b"], "--Frames", "0-2", "-o",
              str(tmp_path / f"{name}-++.npz"), "--levels", "2"] + extra)
    assert capsys.readouterr().out.count("wrote") == 6
    for f in ("{}.npz", "{}-00.npz", "{}-01.npz"):
        t = load_image(str(tmp_path / f.format("t")))
        assert t.shape == (16, 16, 3) and not t[..., 2].any()
        np.testing.assert_array_equal(t, load_image(str(tmp_path /
                                                        f.format("j"))))


def test_pathtracer_denoise_app(tmp_path, capsys):
    """pathtracer --denoise --ascii on the CPU: the frame is the render's
    accum through render_aovs and the default Denoiser, sRGB-encoded; the
    preview is printed."""
    out = str(tmp_path / "pt.ppm")
    tpathtracer.main(["--file", out, "--dim", "16x16", "--samples", "2",
                      "--launch-samples", "1", "--depth", "2", "--denoise",
                      "--ascii", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "wrote" in text and len(text.splitlines()) > 10
    scene = tb.cornell_box("cpu")
    cam = tb.cornell_camera(16, 16)
    accum, _, _ = tpathtracer.render(16, 16, samples=2, max_depth=2,
                                     scene=scene, camera=cam,
                                     samples_per_launch=1, device="cpu")
    aovs = tengine.render_aovs(scene, cam.params("cpu"), 16, 16)
    den = Denoiser(device="cpu").setup(16, 16).invoke(
        accum, albedo=aovs["albedo"], normal=aovs["normal"],
        emission=aovs["emission"])
    assert not torch.equal(den, accum)
    want = tfilm.make_color(den).numpy()[..., :3]
    np.testing.assert_array_equal(load_image(out), want)
