"""The port's motion blur (accel/motion.py, the moving triangles in the
scene, the engine's per-path shutter times, the two motion apps) against
the JAX package on the CPU, on the same numpy inputs made from a seed.

Bars: hit masks and ids equal, t, uv and normals within 1e-5 (the
acceptance bar); the SRT transforms within 1e-5 (`_slerp`'s arccos and sin
may round apart from XLA's in the last ulp); renders with equal ray counts
and radiance within atol 2e-3 / rtol 1e-3, where the pixels outside the bar
are counted and required to be none. The JAX renders run as the
reference's tests run them, jitted. About 40 s on one worker, most of it
the JAX compiles of render_accumulate.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_raytracer_tpu.accel import motion as jmotion
from optix_raytracer_tpu.apps import motion_geometry as jmg
from optix_raytracer_tpu.apps import simple_motion_blur as jsmb
from optix_raytracer_tpu.core import film as jfilm
from optix_raytracer_tpu.core.camera import Camera as JCamera
from optix_raytracer_tpu.core.rays import Hits as JHits
from optix_raytracer_tpu.core.rays import Rays as JRays
from optix_raytracer_tpu.scene.device_scene import (
    make_device_scene as jmake_device_scene)
from optix_raytracer_tpu.shade.lights import ParallelogramLight as JLight
from optix_raytracer_tpu.wavefront import engine as jengine
from optix_raytracer_tpu_torch.accel import motion
from optix_raytracer_tpu_torch.accel import primitives as prim
from optix_raytracer_tpu_torch.apps import motion_geometry as mg
from optix_raytracer_tpu_torch.apps import simple_motion_blur as smb
from optix_raytracer_tpu_torch.core.film import Film
from optix_raytracer_tpu_torch.core.rays import Hits, Rays
from optix_raytracer_tpu_torch.scene.device_scene import make_device_scene
from optix_raytracer_tpu_torch.shade import materials as M
from optix_raytracer_tpu_torch.shade.lights import ParallelogramLight
from optix_raytracer_tpu_torch.wavefront import engine, intersect

from torch_parity import (assert_image_close, one_torch_thread,  # noqa: F401
                          torch_cam, torch_scene)

HIT_TOL = 1e-5


def _moving_mesh(rng, m=12):
    """m random triangles and their second key, moved by a random shift
    and wobble."""
    v0 = rng.uniform(-1, 1, (m, 3))
    verts0 = np.concatenate([v0, v0 + rng.uniform(-0.8, 0.8, (m, 3)),
                             v0 + rng.uniform(-0.8, 0.8, (m, 3))])
    verts1 = (verts0 + rng.uniform(-0.6, 0.6, (1, 3))
              + rng.uniform(-0.1, 0.1, verts0.shape))
    idx = np.arange(3 * m).reshape(3, m).T.copy()
    return (verts0.astype(np.float32), verts1.astype(np.float32),
            idx.astype(np.int32))


def _rays(rng, n=800, aim=None):
    o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    if aim is not None:
        half = np.arange(n) % 2 == 0
        d[half] = aim[rng.integers(0, len(aim), half.sum())] - o[half]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.where(np.arange(n) % 7 == 0, 1.0, 50.0).astype(np.float32)
    return ((o, d, tmin, tmax),
            JRays(origin=jnp.asarray(o), direction=jnp.asarray(d),
                  tmin=jnp.asarray(tmin), tmax=jnp.asarray(tmax)),
            Rays(origin=torch.as_tensor(o), direction=torch.as_tensor(d),
                 tmin=torch.as_tensor(tmin), tmax=torch.as_tensor(tmax)))


def _assert_hits(out: Hits, ref: JHits, what):
    for f in ("prim_id", "inst_id", "mat_id"):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f"{what}: {f}")
    hit = out.prim_id.numpy() >= 0
    assert hit.any() and (~hit).any(), f"{what}: degenerate rays"
    for f in ("t", "uv", "normal"):
        np.testing.assert_allclose(getattr(out, f).numpy()[hit],
                                   np.asarray(getattr(ref, f))[hit],
                                   rtol=HIT_TOL, atol=HIT_TOL,
                                   err_msg=f"{what}: {f}")
    np.testing.assert_array_equal(out.normal.numpy()[~hit], 0.0)


TIMES = ["0", "0.5", "1", "random"]


def _times(which, n, rng):
    if which == "random":
        return rng.uniform(0, 1, n).astype(np.float32)
    return np.full(n, float(which), np.float32)


@pytest.mark.parametrize("which", TIMES)
def test_motion_triangles_match_jax(which):
    rng = np.random.default_rng(3)
    verts0, verts1, idx = _moving_mesh(rng)
    centroids = 0.5 * (verts0 + verts1).reshape(3, -1, 3).mean(axis=0)
    _, jr, tr = _rays(rng, aim=centroids)
    times = _times(which, tr.tmin.shape[0], rng)
    ref = jmotion.intersect_motion_triangles(
        jmotion.MotionTriangles.make(verts0, verts1, idx), jr,
        jnp.asarray(times))
    geom = motion.MotionTriangles.make(verts0, verts1, idx, "cpu")
    out = motion.intersect_motion_triangles(geom, tr, torch.as_tensor(times))
    _assert_hits(out, ref, f"motion triangles at t={which}")


@pytest.mark.parametrize("which", TIMES)
def test_motion_spheres_match_jax(which):
    rng = np.random.default_rng(4)
    c0 = rng.uniform(-1, 1, (5, 3)).astype(np.float32)
    c1 = (c0 + rng.uniform(-0.7, 0.7, (5, 3))).astype(np.float32)
    radii = rng.uniform(0.2, 0.5, 5).astype(np.float32)
    _, jr, tr = _rays(rng, aim=0.5 * (c0 + c1))
    times = _times(which, tr.tmin.shape[0], rng)
    ref = jmotion.intersect_motion_spheres(c0, c1, radii, jr,
                                           jnp.asarray(times))
    out = motion.intersect_motion_spheres(c0, c1, radii, tr,
                                          torch.as_tensor(times))
    _assert_hits(out, ref, f"motion spheres at t={which}")


def test_motion_chunks_do_not_change_answers(monkeypatch):
    """Rays split into chunks of a few rays give the same hits."""
    rng = np.random.default_rng(5)
    verts0, verts1, idx = _moving_mesh(rng)
    _, _, tr = _rays(rng, n=300)
    times = torch.as_tensor(rng.uniform(0, 1, 300).astype(np.float32))
    geom = motion.MotionTriangles.make(verts0, verts1, idx, "cpu")
    whole = motion.intersect_motion_triangles(geom, tr, times)
    monkeypatch.setattr(prim, "PLANE_ELEMS", 7 * geom.num_triangles)
    assert len(prim.chunk_bounds(300, geom.num_triangles)) == 43
    parts = motion.intersect_motion_triangles(geom, tr, times)
    for f in ("t", "prim_id", "uv", "normal"):
        assert torch.equal(getattr(whole, f), getattr(parts, f)), f


def test_srt_transforms_match_jax():
    """srt_interpolate (a spin of 0.6 rad about a tilted axis, a scale and
    a lift between the keys; and two keys 1e-5 rad apart, the lerp branch),
    rays_to_object_space and hits_to_world_space."""
    rng = np.random.default_rng(6)
    n = 400
    times = rng.uniform(0, 1, n).astype(np.float32)
    axis = np.array([0.3, 0.2, 0.93])
    axis /= np.linalg.norm(axis)
    cases = [((0.0, 0.6), (1.0, 1.3, 0.8), (0.2, 0.15, -0.1)),
             ((0.0, 1e-5), (1.0, 1.0, 1.0), (0.0, 0.0, 0.0))]
    (o, d, tmin, tmax), jr, tr = _rays(rng, n)
    for (a0, a1), scale1, trans1 in cases:
        def quat(a):
            return tuple(np.sin(a / 2) * axis) + (np.cos(a / 2),)

        jk = (jmotion.SRTKey.make(quat=quat(a0)),
              jmotion.SRTKey.make(scale=scale1, quat=quat(a1),
                                  trans=trans1))
        tk = (motion.SRTKey.make("cpu", quat=quat(a0)),
              motion.SRTKey.make("cpu", scale=scale1, quat=quat(a1),
                                 trans=trans1))
        js = jmotion.srt_interpolate(*jk, jnp.asarray(times))
        ts = motion.srt_interpolate(*tk, torch.as_tensor(times))
        for k in ("scale", "quat", "trans"):
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       rtol=HIT_TOL, atol=HIT_TOL,
                                       err_msg=k)
        jo = jmotion.rays_to_object_space(jr, js)
        to = motion.rays_to_object_space(tr, ts)
        for f in ("origin", "direction", "tmin", "tmax"):
            np.testing.assert_allclose(getattr(to, f).numpy(),
                                       np.asarray(getattr(jo, f)),
                                       rtol=HIT_TOL, atol=HIT_TOL,
                                       err_msg=f)
        normal = rng.normal(size=(n, 3)).astype(np.float32)
        prim_id = np.where(np.arange(n) % 3 == 0, -1, 1).astype(np.int32)
        jh = JHits(t=jnp.asarray(tmax), prim_id=jnp.asarray(prim_id),
                   inst_id=jnp.asarray(prim_id), mat_id=jnp.asarray(prim_id),
                   uv=jnp.zeros((n, 2)), normal=jnp.asarray(normal))
        th = Hits(t=torch.as_tensor(tmax), prim_id=torch.as_tensor(prim_id),
                  inst_id=torch.as_tensor(prim_id),
                  mat_id=torch.as_tensor(prim_id), uv=torch.zeros((n, 2)),
                  normal=torch.as_tensor(normal))
        np.testing.assert_allclose(
            motion.hits_to_world_space(th, ts).normal.numpy(),
            np.asarray(jmotion.hits_to_world_space(jh, js).normal),
            rtol=HIT_TOL, atol=HIT_TOL)


def _engine_render(jscene, scene, jcam, w=16, h=16, spl=4, depth=2):
    jf, jrays = jengine.render_accumulate(
        jscene, jcam, jfilm.Film.create(h, w), w, h,
        samples_per_launch=spl, max_depth=depth, chunk_size=None)
    tf, trays = engine.render_accumulate(
        scene, torch_cam(jcam), Film.create(h, w, "cpu"), w, h,
        samples_per_launch=spl, max_depth=depth, chunk_size=None)
    return np.asarray(jf.accum), tf.accum.numpy(), int(jrays), int(trays)


def _jax_blur_scene():
    """The JAX twin of simple_motion_blur.engine_scene."""
    floor = np.array([[-3, -0.6, -3], [3, -0.6, -3], [3, -0.6, 3],
                      [-3, -0.6, 3]], np.float32)
    tri0 = smb._TRI0
    return jmake_device_scene(
        floor, np.array([[0, 2, 1], [0, 3, 2]], np.int32),
        np.zeros(2, np.int32),
        [{"kind": M.DIFFUSE, "base_color": (0.6, 0.6, 0.65)},
         {"kind": M.DIFFUSE, "base_color": (0.9, 0.4, 0.2)}],
        area_light=JLight.make((-1, 3.0, -1), (2, 0, 0), (0, 0, 2),
                               (10.0, 10.0, 10.0)),
        motion={"verts0": tri0,
                "verts1": tri0 + np.array([1.4, 0.0, 0.0], np.float32),
                "indices": np.array([[0, 1, 2]], np.int32), "tri_mat": 1})


@pytest.mark.parametrize("handed_over", [True, False])
def test_motion_engine_matches_jax(handed_over):
    """render_accumulate on the motion-blur engine scene (the moving
    triangle beside the floor, depth 2): the JAX scene handed over, and the
    port's own build (simple_motion_blur.engine_scene)."""
    jscene = _jax_blur_scene()
    scene = torch_scene(jscene) if handed_over else smb.engine_scene("cpu")
    assert scene.has_motion and scene.motion_geom.num_triangles == 1
    assert scene.motion_tri_mat.tolist() == [1]
    jcam = JCamera(eye=(0, 0.6, 3.2), lookat=(0, -0.1, 0), fov_y=45,
                   aspect=1.0).params()
    ref, out, jrays, trays = _engine_render(jscene, scene, jcam, spl=8)
    assert trays == jrays
    assert_image_close(out, ref, "motion-blur engine")
    assert ref.max() > 0.1


def test_moving_quad_engine_matches_jax():
    """The moving emissive quad of tests/test_volume_motion_engine.py at
    sweep 0 and 1.2 (depth 1, 16 samples): each path's shutter time is its
    first draw, so the blurred footprint and every later draw match."""
    q0 = np.array([[-0.25, -0.6, 0], [0.25, -0.6, 0], [0.25, 0.6, 0],
                   [-0.25, 0.6, 0]], np.float32)
    idx_q = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    mats = [{"kind": M.DIFFUSE, "base_color": (0, 0, 0)},
            {"kind": M.DIFFUSE, "base_color": (0, 0, 0),
             "emission": (5.0, 5.0, 5.0)}]
    no_light = ((0, 0, 0), (1, 0, 0), (0, 0, 1), (0.0, 0.0, 0.0))
    empty_v, empty_i = np.zeros((3, 3), np.float32), np.zeros((1, 3), np.int32)
    jcam = JCamera(eye=(0.6, 0, -4), lookat=(0.6, 0, 0), up=(0, 1, 0),
                   fov_y=30.0, aspect=3.0).params()
    for sweep in (0.0, 1.2):
        mo = {"verts0": q0, "verts1": q0 + np.array([sweep, 0, 0],
                                                     np.float32),
              "indices": idx_q, "tri_mat": 1}
        jscene = jmake_device_scene(empty_v, empty_i, np.zeros(1, np.int32),
                                    mats, area_light=JLight.make(*no_light),
                                    motion=mo)
        scene = make_device_scene(
            empty_v, empty_i, np.zeros(1, np.int32), mats, "cpu",
            area_light=ParallelogramLight.make(*no_light, "cpu"), motion=mo)
        ref, out, jrays, trays = _engine_render(jscene, scene, jcam, w=24,
                                                h=8, spl=16, depth=1)
        assert trays == jrays
        assert_image_close(out, ref, f"moving quad, sweep {sweep}")
        assert ref.max() > 1.0


def test_motion_cutout_refuses_micromaps():
    """A moving triangle whose material is an alpha cutout: the micromaps
    are refused, in both packages, and the render (shadow rays through the
    loop without micromaps, where the moving triangles stand at time 0, as
    in the reference) matches."""
    floor = np.array([[-3, -0.6, -3], [3, -0.6, -3], [3, -0.6, 3],
                      [-3, -0.6, 3]], np.float32)
    idx_f = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    tri0 = smb._TRI0 + np.array([0.5, 0.3, 0.0], np.float32)
    mats = [{"kind": M.DIFFUSE, "base_color": (0.6, 0.6, 0.65),
             "alpha_mode": 1, "cutout": M.CUT_CHECKER,
             "checker_scale": 4.0},
            {"kind": M.DIFFUSE, "base_color": (0.9, 0.4, 0.2),
             "alpha_mode": 1, "cutout": M.CUT_CIRCLE, "checker_scale": 3.0}]
    light = ((-1, 3.0, -1), (2, 0, 0), (0, 0, 2), (10.0, 10.0, 10.0))
    mo = {"verts0": tri0, "verts1": tri0 + np.array([0.9, 0.0, 0.0],
                                                    np.float32),
          "indices": np.array([[0, 1, 2]], np.int32), "tri_mat": 1}
    jscene = jmake_device_scene(floor, idx_f, np.zeros(2, np.int32), mats,
                                area_light=JLight.make(*light), motion=mo)
    scene = make_device_scene(floor, idx_f, np.zeros(2, np.int32), mats,
                              "cpu", area_light=ParallelogramLight.make(
                                  *light, "cpu"), motion=mo)
    assert jscene.has_cutouts and jscene.omm_summary.shape[0] == 0
    assert scene.has_cutouts and not scene.has_omm and scene.has_motion
    # a static moving-triangle material keeps the micromaps
    kept = make_device_scene(floor, idx_f, np.zeros(2, np.int32),
                             mats + [{"kind": M.DIFFUSE}], "cpu",
                             motion=dict(mo, tri_mat=2))
    assert kept.has_omm
    jcam = JCamera(eye=(0, 0.6, 3.2), lookat=(0, -0.1, 0), fov_y=45,
                   aspect=1.0).params()
    ref, out, jrays, trays = _engine_render(jscene, scene, jcam, spl=4)
    assert trays == jrays
    assert_image_close(out, ref, "motion cutout")
    # the handed-over JAX scene takes the same path
    handed = torch_scene(jscene)
    assert handed.has_motion and not handed.has_omm


def test_motion_scene_queries_and_fused_rule():
    """scene_closest / scene_any with and without times: motion hits come
    after the triangles and prims (ids num_triangles + prims.num + row),
    times None is time 0; the fused kernel takes no motion scene."""
    scene = smb.engine_scene("cpu")
    rays = Rays.make(torch.tensor([[-0.8, 0.0, 2.0], [0.6, 0.0, 2.0]]),
                     torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]]))
    h0 = intersect.scene_closest(scene, rays)
    h1 = intersect.scene_closest(scene, rays, times=torch.ones(2))
    assert h0.prim_id.tolist()[0] == 2 and h0.mat_id.tolist()[0] == 1
    assert h1.prim_id.tolist()[1] == 2 and h1.mat_id.tolist()[1] == 1
    assert h0.prim_id.tolist()[1] == h1.prim_id.tolist()[0] == -1
    assert intersect.scene_any(scene, rays).tolist() == [True, False]
    assert intersect.scene_any(scene, rays,
                               times=torch.ones(2)).tolist() == [False, True]
    assert not engine._use_fused(dataclasses.replace(scene), "auto")
    with pytest.raises(NotImplementedError, match="moving"):
        engine.render_accumulate(scene, smb.engine_camera(4, 4).params("cpu"),
                                 Film.create(4, 4, "cpu"), 4, 4,
                                 impl="fused")


def test_motion_blur_app_matches_jax():
    """The standalone renderer and --engine at 16x16 on the CPU."""
    out, film = smb.render(16, 16, samples=3, device="cpu")
    ref, jf = jsmb.render(16, 16, samples=3)
    assert int(film.subframe) == int(jf.subframe) == 3
    assert_image_close(out.numpy(), ref, "simple_motion_blur")
    out, film, rays = smb.render_engine(16, 16, 8, device="cpu")
    ref, _ = jsmb.render_engine(16, 16, 8)
    assert_image_close(out.numpy(), ref, "simple_motion_blur --engine")
    assert int(rays) > 16 * 16 * 8


def test_motion_geometry_app_matches_jax():
    out, film = mg.render(16, 16, samples=3, device="cpu")
    ref, _ = jmg.render(16, 16, samples=3)
    assert_image_close(out.numpy(), ref, "motion_geometry")
    assert float(out.max()) > 0.2


def test_motion_apps_cli(tmp_path):
    """main() of both apps writes its image on --device cpu."""
    for app, extra in ((smb, []), (smb, ["--engine"]), (mg, [])):
        path = tmp_path / f"{app.__name__.rsplit('.', 1)[1]}{len(extra)}.ppm"
        app.main(["--file", str(path), "--dim", "8x8", "--samples", "2",
                  "--device", "cpu", *extra])
        assert path.stat().st_size == len(b"P6\n8 8\n255\n") + 8 * 8 * 3
