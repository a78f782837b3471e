"""The last single-chip apps of the port (`apps/{hello,triangle,console,
custom_primitive,dynamic_materials,raycasting,viewer}.py` and the
meshviewer's `--model` / `--animate`) against the JAX apps on the CPU, at
16-32².

Bars: linear radiance within atol 2e-3 / rtol 1e-3, at most FLIPS pixels
outside (a branch flipped by an ulp). The JAX apps that encode their
images with `film.make_color` are read through it swapped for the identity
(monkeypatch). The viewer cases mirror the portable tests of
`tests/test_viewer_checkpoint.py`: a `--checkpoint` / `--resume` split equals
the straight run (and the JAX viewer's frames), camera keys and `r` reset
the accumulation, the settings keys, the mouse routes and the trackball's
moves equal the JAX trackball's; the ANSI loop with injected keys and the
HTTP view on 127.0.0.1. About 60 s on one worker, most of it JAX compiles.
"""
import dataclasses
import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_raytracer_tpu.apps import console as jconsole
from optix_raytracer_tpu.apps import custom_primitive as jcustom
from optix_raytracer_tpu.apps import dynamic_materials as jdynmat
from optix_raytracer_tpu.apps import hello as jhello
from optix_raytracer_tpu.apps import meshviewer as jmeshviewer
from optix_raytracer_tpu.apps import raycasting as jraycasting
from optix_raytracer_tpu.apps import triangle as jtriangle
from optix_raytracer_tpu.apps import viewer as jviewer
from optix_raytracer_tpu.core import film as jfilm
from optix_raytracer_tpu.core.camera import Camera as JCamera
from optix_raytracer_tpu.core.camera import Trackball as JTrackball
from optix_raytracer_tpu.scene import builtins as jbuiltins
from optix_raytracer_tpu.scene.scene import Scene as JScene
from optix_raytracer_tpu_torch.apps import (console, custom_primitive,
                                            dynamic_materials, hello,
                                            meshviewer, raycasting, triangle,
                                            viewer)
from optix_raytracer_tpu_torch.core.camera import Camera, Trackball
from optix_raytracer_tpu_torch.core.film import OutputBuffer, make_color
from optix_raytracer_tpu_torch.io.image import load_image
from optix_raytracer_tpu_torch.scene.builtins import cornell_box
from optix_raytracer_tpu_torch.tools import model_probe as mp

from torch_parity import jax_native_sah, one_torch_thread  # noqa: F401

ATOL, RTOL = 2e-3, 1e-3
FLIPS = 2


def _close(out, ref, what):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape and np.isfinite(out).all(), what
    ok = np.isclose(out, ref, atol=ATOL, rtol=RTOL).all(axis=-1)
    assert int((~ok).sum()) <= FLIPS, (
        f"{what}: {int((~ok).sum())} pixels outside, max "
        f"{np.abs(out - ref).max()}")


@pytest.fixture
def jax_radiance(monkeypatch):
    monkeypatch.setattr(jfilm, "make_color", lambda r: r)


def test_hello_app(jax_radiance, tmp_path):
    ref = np.asarray(jhello.render(16, 12))
    out = hello.render(16, 12, device="cpu")
    assert out.dtype == torch.uint8 and out.shape == (12, 16, 4)
    np.testing.assert_array_equal(
        out.numpy()[..., :3],
        make_color(torch.as_tensor(np.array(ref)))[..., :3].numpy())
    hello.main(["--file", str(tmp_path / "h.ppm"), "--dim", "8x4",
                "--device", "cpu"])
    assert load_image(str(tmp_path / "h.ppm")).shape[:2] == (4, 8)


def test_triangle_app(jax_radiance, tmp_path, capsys):
    out = triangle.radiance(24, 24, device="cpu")
    _close(out.numpy(), jtriangle.render(24, 24), "triangle")
    assert float(out[12, 12].sum()) > 0.9          # the triangle's middle
    assert torch.equal(triangle.render(24, 24, device="cpu"),
                       make_color(out))
    triangle.main(["--file", str(tmp_path / "t.ppm"), "--dim", "16x16",
                   "--device", "cpu", "--ascii"])
    assert "wrote" in capsys.readouterr().out


def test_custom_primitive_app(jax_radiance):
    out = custom_primitive.radiance(24, 16, device="cpu")
    _close(out.numpy(), jcustom.render(24, 16), "custom primitive")
    assert float(out.max()) > 0.5 and float(out[0, 0].sum()) == 0.0


def test_console_app(one_torch_thread, capsys):
    out = console.render(samples=2, max_depth=2, device="cpu")
    ref = jconsole.render(samples=2, max_depth=2)
    _close(out, ref, "console")
    console.main(["--samples", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) > 10 and all(len(line) == console.WIDTH
                                   for line in lines)


@pytest.mark.parametrize("phase", [0, 1, 2])
def test_dynamic_materials_app(one_torch_thread, phase):
    out, rays = dynamic_materials.render(16, 16, samples=2, phase=phase,
                                         device="cpu")
    ref = jdynmat.render(16, 16, samples=2, phase=phase)
    _close(out.numpy(), ref, f"phase {phase}")
    assert int(rays) > 0
    scene = dynamic_materials.scene_for_phase(phase, "cpu")
    base = cornell_box("cpu")
    assert torch.equal(scene.materials.base_color[0],
                       torch.tensor([0.9, 0.7, 0.2]) if phase else
                       base.materials.base_color[0])
    assert bool((scene.tri_mat[20:30] == 2).all()) == (phase == 2)
    assert torch.equal(base.tri_mat, cornell_box("cpu").tri_mat)


def _glb(tmp_path):
    meshes, materials, images = mp.knot_model(6, 5, tex_size=16)
    return mp.write_gltf(tmp_path / "k.glb", meshes, materials, images,
                         camera=mp.KNOT_CAMERA, light=mp.KNOT_LIGHT,
                         animation=mp.KNOT_SPIN)


@pytest.mark.parametrize("model", [False, True])
def test_raycasting_app(one_torch_thread, tmp_path, model):
    path = _glb(tmp_path) if model else None
    scene, lo, hi = raycasting.build(path, "cpu")
    img, rays, off = raycasting.render(scene, lo, hi, 16, 16)
    if model:
        jhost = JScene.load(path)
        jlo, jhi = jhost.aabb()
        jscene = jhost.finalize()
    else:
        jscene = jbuiltins.cornell_box()
        jlo, jhi = raycasting.CORNELL_BOX
    np.testing.assert_array_equal(lo, jlo)
    jr = jraycasting.create_rays_ortho(16, 16, jlo, jhi)
    # XLA contracts the grid's a * b + c into an FMA: within an ulp of the
    # sum's largest term
    ref_o = np.asarray(jr.origin)
    np.testing.assert_allclose(rays.origin.numpy(), ref_o, rtol=0,
                               atol=2.0 ** -23 * np.abs(ref_o).max())
    a = jraycasting.shade_hits(jraycasting.cast(jscene, jr))
    b = jraycasting.shade_hits(jraycasting.cast(
        jscene, jraycasting.translate_rays(jr, off)))
    ref = np.concatenate([np.asarray(a).reshape(16, 16, 3),
                          np.asarray(b).reshape(16, 16, 3)], axis=1)
    _close(img.numpy(), ref, f"raycasting model={model}")
    assert float(img.max()) > 0.5
    serial, flight = raycasting.measure_overlap(scene, rays, off, reps=1)
    assert serial > 0 and flight > 0
    raycasting.main(["--file", str(tmp_path / "r.ppm"), "--dim", "8x8",
                     "--device", "cpu"]
                    + (["--model", path] if model else []))
    assert load_image(str(tmp_path / "r.ppm")).shape[:2] == (8, 16)


def test_meshviewer_model_and_animate(one_torch_thread, tmp_path):
    path = _glb(tmp_path)
    w = h = 16
    paths, dur = meshviewer.render_animation(path, 3, str(tmp_path / "f.ppm"),
                                             w, h, samples=1, max_depth=2,
                                             device="cpu")
    assert dur == 1.0 and len(paths) == 3
    frames = [load_image(p) for p in paths]
    assert not np.array_equal(frames[0], frames[1])
    assert not np.array_equal(frames[1], frames[2])
    for t, frame in zip((0.0, 0.5, 1.0), frames):
        ref, _ = jmeshviewer.render(path, w, h, samples=1, max_depth=2,
                                    scene=JScene.load(path, time=t))
        own, _, _ = meshviewer.render(path, w, h, samples=1, max_depth=2,
                                      scene=meshviewer.Scene.load(path,
                                                                  time=t),
                                      device="cpu")
        _close(own.numpy(), ref, f"frame t={t}")
        np.testing.assert_array_equal(frame, make_color(own).numpy()[..., :3])
    meshviewer.main(["--model", path, "--time", "0.5", "--dim", "8x8",
                     "--samples", "1", "--file", str(tmp_path / "m.ppm"),
                     "--device", "cpu"])
    meshviewer.main(["--model", path, "--animate", "2", "--dim", "8x8",
                     "--samples", "1", "--file", str(tmp_path / "a.ppm"),
                     "--device", "cpu"])
    assert (tmp_path / "a_001.ppm").exists()


def _viewer(w=16, h=16, spf_log2=1):
    return viewer.TracerViewer(cornell_box("cpu"),
                               viewer.cornell_camera(w, h), w, h,
                               spf_log2=spf_log2, max_depth=2)


def test_viewer_frames_match_jax(one_torch_thread):
    v = _viewer()
    jv = jviewer.TracerViewer(jbuiltins.cornell_box(),
                              jbuiltins.cornell_camera(16, 16), 16, 16,
                              spf_log2=1, max_depth=2)
    for _ in range(2):
        img = v.step()
        jv.step()
    assert img.shape == (16, 16, 4) and img.dtype == np.uint8
    assert int(v.film.subframe) == int(jv.film.subframe) == 4
    _close(v.film.accum.numpy(), jv.film.accum, "viewer")
    assert "render" in v.timers.report() and "fps" in v.stats_line()


def test_viewer_resume_equals_straight_run(one_torch_thread, tmp_path):
    common = ["--dim", "16x16", "--spf", "1", "--depth", "2", "--device",
              "cpu", "--file", str(tmp_path / "v.ppm")]
    straight, _ = viewer.main(common + ["--frames", "4"])
    ck = str(tmp_path / "ck.npz")
    viewer.main(common + ["--frames", "2", "--checkpoint", ck])
    resumed, _ = viewer.main(common + ["--frames", "2", "--resume", ck])
    assert int(resumed.film.subframe) == int(straight.film.subframe) == 8
    torch.testing.assert_close(resumed.film.accum, straight.film.accum,
                               rtol=1e-5, atol=1e-6)
    assert dataclasses.asdict(resumed.camera) == dataclasses.asdict(
        straight.camera)
    # whitted and --model builds run headless too
    w, _ = viewer.main(common + ["--frames", "1", "--scene", "whitted"])
    assert w.integrator == "whitted" and int(w.film.subframe) == 1
    m, img = viewer.main(common + ["--frames", "1", "--model",
                                   _glb(tmp_path)])
    assert m.integrator == "whitted" and img.mean() > 5


def test_viewer_keys_and_trackball(one_torch_thread):
    v = _viewer()
    v.step()
    eye0 = np.asarray(v.camera.eye)
    v.key("w")
    assert v.dirty and not np.allclose(np.asarray(v.camera.eye), eye0)
    v.step()
    assert int(v.film.subframe) == v.spf          # reset, then one frame
    look0 = np.asarray(v.camera.lookat) - np.asarray(v.camera.eye)
    v.key("left")
    look1 = np.asarray(v.camera.lookat) - np.asarray(v.camera.eye)
    assert v.dirty and (look0 @ look1) / (np.linalg.norm(look0)
                                          * np.linalg.norm(look1)) < 0.9999
    s0 = v.spf
    v.key("+")
    assert v.spf == 2 * s0
    v.key("-")
    v.key("-")
    assert v.spf == max(s0 // 2, 1)
    f0, a0 = v.camera.fov_y, v.camera.aperture
    v.key("[")
    assert v.camera.fov_y == f0 - 5
    v.key("]")
    v.key("0")
    assert v.camera.fov_y == f0 and v.camera.aperture == a0 + 2.0
    v.key("9")
    assert v.camera.aperture == a0
    v.step()
    v.key("r")
    v.step()
    assert int(v.film.subframe) == v.spf
    for kind, dx, dy in (("drag_left", 10, 4), ("drag_right", 5, -3),
                         ("scroll", 0, 1), ("scroll", 0, -1)):
        v.dirty = False
        v.mouse(kind, dx, dy)
        assert v.dirty, kind
    v.dirty = False
    v.mouse("hover")
    assert not v.dirty
    # the trackball's moves equal the JAX trackball's
    kw = dict(eye=(1.0, 2.0, 8.0), lookat=(0.5, 0.0, 0.0), up=(0, 1, 0),
              fov_y=40.0, aspect=1.5)
    cam, jcam = Camera(**kw), JCamera(**kw)
    tb, jtb = Trackball(cam, move_speed=3.0), JTrackball(jcam,
                                                         move_speed=3.0)
    for op, args in (("orbit", (30, -12)), ("zoom", (1,)), ("zoom", (-1,)),
                     ("pan", (0.4, -0.2)), ("move", ("a",)),
                     ("move", ("E",)), ("move", ("x",))):
        getattr(tb, op)(*args)
        getattr(jtb, op)(*args)
        for key in ("eye", "lookat"):
            np.testing.assert_array_equal(np.asarray(getattr(cam, key)),
                                          np.asarray(getattr(jcam, key)))


def test_viewer_live_loops(one_torch_thread, tmp_path):
    v = _viewer(8, 8, spf_log2=0)
    keys = iter([["w", "k"], [" "], ["+", "q"]])
    out = []
    frames = viewer.run_ansi(v, str(tmp_path / "s.ppm"), max_frames=5,
                             cols=8, read_keys=lambda: next(keys),
                             write=out.append)
    assert frames == 2 and (tmp_path / "s.ppm").exists() and v.spf == 2
    assert "\x1b[38;2;" in "".join(out) and "spp" in "".join(out)
    img = np.zeros((4, 6, 4), np.uint8)
    img[:2] = (255, 0, 0, 255)
    assert viewer.ansi_frame(img, cols=6) == jviewer.ansi_frame(img, cols=6)
    server = viewer.ViewerServer(v, port=0)
    try:
        url = f"http://127.0.0.1:{server.port}"
        urllib.request.urlopen(urllib.request.Request(
            url + "/key?k=d", method="POST"), timeout=10).read()
        urllib.request.urlopen(urllib.request.Request(
            url + "/mouse?k=drag_left&dx=3&dy=1", method="POST"),
            timeout=10).read()
        assert server.pending_keys() == ["d"]
        assert server.pending_mouse() == [("drag_left", 3.0, 1.0)]
        server.publish(v.step(), v.stats_line())
        with urllib.request.urlopen(url + "/frame.png", timeout=10) as r:
            assert r.read(8) == b"\x89PNG\r\n\x1a\n"
            assert "spp" in r.headers["X-Status"]
    finally:
        server.close()
    buf = OutputBuffer(6, 4)
    assert buf.get_host().shape == (4, 6, 4)
    buf.set(make_color(torch.ones(4, 6, 3)))
    assert int(buf.get_host()[0, 0, 0]) == 255 and buf.map() is not None
    buf.resize(3, 2)
    assert buf.get_host().shape == (2, 3, 4)
    assert json.dumps(dataclasses.asdict(v.camera))
