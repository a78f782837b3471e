"""`Scene.load` → `finalize` → renders of the port against the JAX
package's on the same model files.

Models: the reference's textured cube (`tests/test_scene_gltf.py::
make_cube_gltf`, a PNG in a .glb), the small knot model of
`tools/model_probe.py` (knot and floor, vertex normals and uvs, a KTX2 map,
a glTF camera, a directional light, a spin animation; 6x5 segments, 62
triangles), the same knot as OBJ and PLY, a MASK material, and the knot
past 512 triangles as OBJ. The host scenes are equal field by field
(materials, lights, cameras, meshes bit for bit, posed at a time too); the
meshviewer's Whitted render at 24x24, depth 2, and a path-traced 16x16 at 2
samples (`render_accumulate`) are within atol 2e-3 / rtol 1e-3 of the JAX
package's, at most FLIPS pixels outside (a branch flipped by an ulp); the
path-traced ray counts are equal (the JAX Whitted sample returns none).
The glTF camera comes first in `default_camera`, with the frame's aspect;
past 512 triangles finalize builds the BVH (and the port its cluster
table). About 40 s on one worker, most of it JAX compiles.
"""
import dataclasses

import numpy as np
import pytest
import torch

from optix_raytracer_tpu.apps import meshviewer as jmeshviewer
from optix_raytracer_tpu.scene.scene import Scene as JScene
from optix_raytracer_tpu.shade.lights import ParallelogramLight as JLight
from optix_raytracer_tpu.wavefront import engine as jengine
from optix_raytracer_tpu.core.film import Film as JFilm
from optix_raytracer_tpu_torch.apps import meshviewer
from optix_raytracer_tpu_torch.core.film import Film
from optix_raytracer_tpu_torch.scene.scene import Scene
from optix_raytracer_tpu_torch.shade import materials as tmats
from optix_raytracer_tpu_torch.shade.lights import ParallelogramLight
from optix_raytracer_tpu_torch.tools import model_probe as mp
from optix_raytracer_tpu_torch.wavefront import engine

from torch_parity import jax_native_sah, one_torch_thread  # noqa: F401
import test_scene_gltf as sg

pytestmark = pytest.mark.usefixtures("jax_native_sah")

ATOL, RTOL = 2e-3, 1e-3
FLIPS = 2
LIGHT = ((-2.0, 6.0, -2.0), (4.0, 0.0, 0.0), (0.0, 0.0, 4.0),
         (14.0, 14.0, 14.0))


def _assert_image(out, ref, what):
    assert out.shape == ref.shape and np.isfinite(out).all(), what
    ok = np.isclose(out, ref, atol=ATOL, rtol=RTOL).all(axis=-1)
    assert int((~ok).sum()) <= FLIPS, (
        f"{what}: {int((~ok).sum())} pixels outside the bars, max "
        f"{np.abs(out - ref).max()}")


def _model(tmp_path, kind):
    if kind == "cube_glb":
        return sg.make_cube_gltf(str(tmp_path / "cube.glb"), binary=True)
    meshes, materials, images = mp.knot_model(6, 5, tex_size=16)
    if kind == "knot_ktx2":
        return mp.write_gltf(tmp_path / "knot.glb", meshes, materials,
                             images, camera=mp.KNOT_CAMERA,
                             light=mp.KNOT_LIGHT, animation=mp.KNOT_SPIN)
    if kind == "knot_mask":
        materials[0].update(alpha_mode="MASK", alpha_cutoff=0.4)
        img = images[0].copy()
        img[::4, :, 3] = 0
        return mp.write_gltf(tmp_path / "mask.gltf", meshes, materials,
                             [img])
    v = np.concatenate([meshes[0]["positions"], meshes[1]["positions"]])
    f = np.concatenate([meshes[0]["indices"],
                        meshes[1]["indices"] + len(meshes[0]["positions"])])
    n = np.concatenate([meshes[0]["normals"], meshes[1]["normals"]])
    uv = np.concatenate([meshes[0]["uvs"], meshes[1]["uvs"]])
    if kind == "knot_obj":
        return mp.write_obj(tmp_path / "knot.obj", v, f, n, uv)
    return mp.write_ply(tmp_path / "knot.ply", v, f, n, uv)


def _assert_host_equal(own, ref):
    assert own.materials == ref.materials
    assert own.lights == ref.lights
    assert len(own.textures) == len(ref.textures)
    for a, b in zip(own.textures, ref.textures):
        np.testing.assert_array_equal(a, b)
    assert [dataclasses.asdict(c) for c in own.cameras] == [
        dataclasses.asdict(c) for c in ref.cameras]
    assert len(own.meshes) == len(ref.meshes)
    for a, b in zip(own.meshes, ref.meshes):
        for name in ("positions", "indices", "normals", "uvs", "transform"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None), name
            if x is not None:
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name
        assert a.material == b.material and a.name == b.name


MODELS = ["cube_glb", "knot_ktx2", "knot_mask", "knot_obj", "knot_ply"]


@pytest.mark.parametrize("kind", MODELS)
def test_loaded_host_scene_equals_jax(tmp_path, kind):
    path = str(_model(tmp_path, kind))
    own, ref = Scene.load(path), JScene.load(path)
    _assert_host_equal(own, ref)
    if kind == "knot_mask":
        assert own.materials[0]["cutout"] == tmats.CUT_TEXTURE
        assert "cutouts" in own.finalize("cpu").features
    if kind == "knot_ktx2":
        assert len(own.cameras) == 1 and len(own.lights) == 1
        for t in (0.0, 0.5, 1.0):
            _assert_host_equal(Scene.load(path, time=t),
                               JScene.load(path, time=t))
        a, b = (Scene.load(path, time=t).finalize("cpu") for t in (0, 1))
        assert a.num_triangles == b.num_triangles == 62
        assert not torch.equal(a.geom.v0, b.geom.v0)


@pytest.mark.parametrize("kind", ["cube_glb", "knot_ktx2", "knot_mask",
                                  "knot_ply"])
def test_meshviewer_render_matches_jax(one_torch_thread, tmp_path, kind):
    path = str(_model(tmp_path, kind))
    img, film, rays = meshviewer.render(path, 24, 24, samples=1,
                                        max_depth=2, device="cpu")
    ref, jfilm = jmeshviewer.render(path, 24, 24, samples=1, max_depth=2)
    _assert_image(img.numpy(), np.asarray(ref), kind)
    assert int(film.subframe) == int(jfilm.subframe) == 1
    assert int(rays) > 0 and img.numpy().mean() > 0.01


def test_pathtraced_load_matches_jax(one_torch_thread, tmp_path):
    path = str(_model(tmp_path, "knot_ktx2"))
    w = h = 16
    own, ref = Scene.load(path, time=0.25), JScene.load(path, time=0.25)
    scene = own.finalize("cpu", area_light=ParallelogramLight.make(
        *LIGHT, "cpu"))
    jscene = ref.finalize(area_light=JLight.make(*LIGHT))
    cam = own.default_camera(w, h)
    film, rays = engine.render_accumulate(
        scene, cam.params("cpu"), Film.create(h, w, "cpu"), w, h,
        samples_per_launch=2, max_depth=3)
    jfilm, jrays = jengine.render_accumulate(
        jscene, ref.default_camera(w, h).params(), JFilm.create(h, w), w, h,
        samples_per_launch=2, max_depth=3)
    _assert_image(film.accum.numpy(), np.asarray(jfilm.accum), "pathtrace")
    assert int(rays) == int(jrays) > 0
    assert film.accum.numpy().mean() > 1e-3


def test_gltf_camera_comes_first(tmp_path):
    path = str(_model(tmp_path, "knot_ktx2"))
    own, ref = Scene.load(path), JScene.load(path)
    cam, jcam = own.default_camera(64, 32), ref.default_camera(64, 32)
    assert dataclasses.asdict(cam) == dataclasses.asdict(jcam)
    assert cam.aspect == 2.0 and own.cameras[0].aspect == 1.0
    np.testing.assert_allclose(cam.eye, mp.KNOT_CAMERA["eye"], atol=1e-6)
    fwd = np.asarray(cam.lookat) - np.asarray(cam.eye)
    want = np.asarray(mp.KNOT_CAMERA["lookat"]) - mp.KNOT_CAMERA["eye"]
    np.testing.assert_allclose(fwd, want / np.linalg.norm(want), atol=1e-6)
    assert cam.fov_y == pytest.approx(45.0)
    # without a glTF camera: the box framing of both packages
    plain = Scene.load(str(_model(tmp_path, "knot_obj")))
    jplain = JScene.load(str(_model(tmp_path, "knot_obj")))
    assert not plain.cameras
    assert dataclasses.asdict(plain.default_camera(20, 10)) == \
        dataclasses.asdict(jplain.default_camera(20, 10))


def test_bvh_past_512_triangles(one_torch_thread, tmp_path):
    """finalize builds the BVH past 512 triangles (scene/scene.py:276-277),
    in both packages; the port's knot also has its cluster table, which
    its queries take, so the render is the JAX BVH walk's."""
    meshes, _, _ = mp.knot_model(20, 14, tex_size=8)
    path = mp.write_obj(tmp_path / "k.obj", meshes[0]["positions"],
                        meshes[0]["indices"], meshes[0]["normals"])
    own, ref = Scene.load(str(path)), JScene.load(str(path))
    scene, jscene = own.finalize("cpu"), ref.finalize()
    assert scene.num_triangles == 560
    assert scene.has_bvh and jscene.bvh is not None and scene.has_clusters
    small = Scene.load(str(_model(tmp_path, "knot_obj"))).finalize("cpu")
    assert not small.has_bvh and not small.has_clusters
    assert own.finalize("cpu", with_bvh=False).bvh is None
    img, _, _ = meshviewer.render(None, 24, 24, samples=1, max_depth=2,
                                  scene=own, device="cpu")
    jimg, _ = jmeshviewer.render(None, 24, 24, samples=1, max_depth=2,
                                 scene=ref)
    _assert_image(img.numpy(), np.asarray(jimg), "knot 560 obj")
