"""Instanced meshes past 512 triangles (`scene/device_scene.py::
_build_instance_clusters`, `accel/tlas.py`'s `mesh_clusters`) against the
JAX package on the CPU.

The scene: two instances of a 960-triangle trefoil (`trefoil_mesh(30, 16)`)
under distinct rotations, scales and offsets with sbt offsets 0 and 1, and
a floor (an identity instance, brute force). The JAX scene is handed over
(`torch_parity.scene_fields`, instance inverses included); the port builds
the mesh's object-space cluster table from the handed geometry in SAH
order, as the JAX scene builds its own. `tlas.intersect_instances` /
`intersect_instances_any` with the tables equal the JAX calls with theirs
(its cluster queries in interpret mode under `GROUPS = 1`, as
`tests/test_tlas_engine.py:270-320` runs them) and the port's brute force:
prim, instance and material ids and occlusion equal, t within rtol 1e-6 /
atol 1e-6 (the Woop test's arithmetic; XLA's FMAs move it by ulps); the
walks' normals, the tables' interpolated smooth normals, within 2e-5 of
JAX's (up to 1.4e-5 seen: XLA's FMAs in the interpolation and the
inverse-transpose product). The instances with a table walk it, the floor takes
brute force, an occluded ray reaches the next instance's walk with an empty
window, and through the port's own `Scene.finalize` the meshviewer's Whitted
render matches the same meshes baked into one flat mesh (the JAX package's
and the port's) and a path-traced launch the JAX package's, within atol
2e-3 / rtol 1e-3 with equal ray counts. About 50 s on one worker.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_raytracer_tpu.accel import clusters as jcl
from optix_raytracer_tpu.accel import tlas as jtlas
from optix_raytracer_tpu.apps import meshviewer as jmeshviewer
from optix_raytracer_tpu.core.camera import Camera as JCamera
from optix_raytracer_tpu.core.film import Film as JFilm
from optix_raytracer_tpu.core.rays import Rays as JRays
from optix_raytracer_tpu.scene.scene import Scene as JScene
from optix_raytracer_tpu.shade.lights import ParallelogramLight as JLight
from optix_raytracer_tpu.wavefront import engine as jengine
from optix_raytracer_tpu_torch.accel import tlas
from optix_raytracer_tpu_torch.apps import meshviewer
from optix_raytracer_tpu_torch.core.camera import Camera
from optix_raytracer_tpu_torch.core.film import Film
from optix_raytracer_tpu_torch.core.rays import Rays
from optix_raytracer_tpu_torch.scene.builtins import trefoil_mesh
from optix_raytracer_tpu_torch.scene.scene import Scene
from optix_raytracer_tpu_torch.shade.lights import ParallelogramLight
from optix_raytracer_tpu_torch.wavefront import engine, pallas_pt

from torch_parity import (jax_native_sah, one_torch_thread,  # noqa: F401
                          torch_scene)

pytestmark = pytest.mark.usefixtures("jax_native_sah")

LIGHT = ((-3.0, 7.0, -3.0), (6.0, 0.0, 0.0), (0.0, 0.0, 6.0),
         (16.0, 16.0, 16.0))
MATS = [{"kind": 0, "base_color": (0.8, 0.4, 0.2)},
        {"kind": 0, "base_color": (0.2, 0.5, 0.8)},
        {"kind": 0, "base_color": (0.7, 0.7, 0.7)}]


def _xf(tx, ty, tz, s, deg, axis):
    a = np.radians(deg)
    c, si = np.cos(a), np.sin(a)
    x, y, z = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    r = np.array([[c + x * x * (1 - c), x * y * (1 - c) - z * si,
                   x * z * (1 - c) + y * si],
                  [y * x * (1 - c) + z * si, c + y * y * (1 - c),
                   y * z * (1 - c) - x * si],
                  [z * x * (1 - c) - y * si, z * y * (1 - c) + x * si,
                   c + z * z * (1 - c)]])
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = r * s
    t[:3, 3] = (tx, ty, tz)
    return t


def build(cls, device=None, flat=False):
    """The scene through `cls`'s Scene (the JAX package's or the port's):
    two knot instances and the floor, or with flat=True the same meshes
    with the transforms baked in (no instance)."""
    verts, idx, normals = trefoil_mesh(30, 16)
    sc = cls()
    for m in MATS:
        sc.add_material(m)
    floor = (np.array([[-8, -3, -8], [8, -3, -8], [8, -3, 8], [-8, -3, 8]],
                      np.float32), np.array([[0, 2, 1], [0, 3, 2]], np.int32))
    xfs = [(_xf(-2.2, 0.3, 0.0, 0.8, 35.0, (0, 1, 0.3)), 0),
           (_xf(2.4, -0.2, 1.0, 0.6, -60.0, (1, 0.2, 0)), 1)]
    if flat:
        for t, sbt in xfs:
            sc.add_mesh(verts, idx, normals=normals, material=sbt,
                        transform=t)
        sc.add_mesh(*floor, material=2)
    else:
        knot = sc.add_mesh(verts, idx, normals=normals, material=0)
        fl = sc.add_mesh(*floor, material=2)
        for t, sbt in xfs:
            sc.add_instance(knot, t, sbt)
        sc.add_instance(fl)
    if device is None:
        return sc, sc.finalize(area_light=JLight.make(*LIGHT))
    return sc, sc.finalize(device, area_light=ParallelogramLight.make(
        *LIGHT, device))


@pytest.fixture(scope="module")
def scenes():
    jhost, jscene = build(JScene)
    return jhost, jscene, torch_scene(jscene)


@pytest.fixture(scope="module")
def jax_interpret():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcl, "GROUPS", 1)
        mp.setattr(jcl, "SUPER", jcl.SUB)
        for name in ("closest_hit", "any_hit"):
            mp.setattr(jcl, name, functools.partial(getattr(jcl, name),
                                                    interpret=True))
        jax.clear_caches()
        yield
    jax.clear_caches()


def _rays(n=1024, seed=9):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    o[:, 2] -= 8.0
    tgt = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n, 100.0, np.float32)
    tmax[::7] = 0.0                                  # dead lanes
    return o, d.astype(np.float32), tmax


def test_scene_builds_the_jax_tables(scenes):
    _, jscene, scene = scenes
    assert set(scene.instance_clusters) == set(jscene.instance_clusters) \
        == {(0, 960)}
    own, ref = scene.instance_clusters[(0, 960)], \
        jscene.instance_clusters[(0, 960)]
    assert own.num_clusters == ref.num_clusters == 8
    np.testing.assert_array_equal(own.slot_prim.numpy(),
                                  np.asarray(ref.slot_prim))
    assert scene.bf_boxes[0] is None and scene.bf_boxes[1] is None
    assert not engine._use_fused(scene, "auto")


def test_instance_queries_match_jax(one_torch_thread, scenes, jax_interpret,
                                    monkeypatch):
    _, jscene, scene = scenes
    o, d, tmax = _rays()
    rays = Rays.make(torch.as_tensor(o), torch.as_tensor(d), tmin=1e-3,
                     tmax=torch.as_tensor(tmax))
    jrays = JRays.make(jnp.asarray(o), jnp.asarray(d), tmin=1e-3,
                       tmax=jnp.asarray(tmax))
    walked = []
    real = tlas.cluster_mod.any_hit

    def spy(cl, r, **kw):
        walked.append(r.tmax.clone())
        return real(cl, r, **kw)

    monkeypatch.setattr(tlas.cluster_mod, "any_hit", spy)
    kw = dict(mesh_clusters=scene.instance_clusters)
    hits = tlas.intersect_instances(scene.geom, scene.instances, rays,
                                    tri_mat=scene.tri_mat, **kw)
    occ = tlas.intersect_instances_any(scene.geom, scene.instances, rays,
                                       **kw)
    brute = tlas.intersect_instances(scene.geom, scene.instances, rays,
                                     tri_mat=scene.tri_mat)
    bocc = tlas.intersect_instances_any(scene.geom, scene.instances, rays)
    jkw = dict(mesh_clusters=jscene.instance_clusters, chunk_size=None)
    ref = jtlas.intersect_instances(jscene.geom, jscene.instances, jrays,
                                    tri_mat=jscene.tri_mat, **jkw)
    jocc = jtlas.intersect_instances_any(jscene.geom, jscene.instances,
                                         jrays, **jkw)
    for other, what in ((ref, "jax"), (brute, "brute force")):
        for f in ("prim_id", "inst_id", "mat_id"):
            np.testing.assert_array_equal(getattr(hits, f).numpy(),
                                          np.asarray(getattr(other, f)),
                                          err_msg=f"{what} {f}")
        hit = hits.valid.numpy()
        np.testing.assert_allclose(hits.t.numpy()[hit],
                                   np.asarray(other.t)[hit], rtol=1e-6,
                                   atol=1e-6, err_msg=what)
    # the walk's normal is the table's interpolated smooth normal (brute
    # force gives the face normal); against JAX's table within 2e-5
    np.testing.assert_allclose(hits.normal.numpy()[hit],
                               np.asarray(ref.normal)[hit], atol=2e-5)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    np.testing.assert_array_equal(occ.numpy(), bocc.numpy())
    hit = hits.valid.numpy()
    inst = hits.inst_id.numpy()
    assert {0, 1, 2} <= set(inst[hit].tolist())
    mat = hits.mat_id.numpy()
    assert (mat[inst == 0] == 0).all() and (mat[inst == 1] == 1).all()
    assert (mat[inst == 2] == 2).all() and (mat[~hit] == -1).all()
    # both knot instances walked their table; the second saw the rays the
    # first occluded with an empty window
    assert len(walked) == 2
    first = tlas.intersect_instances_any(
        scene.geom, tlas.make_instances(
            [scene.instances.transform[0].numpy()], "cpu",
            prim_ranges=[(0, 960)]), rays,
        mesh_clusters=scene.instance_clusters)
    assert bool(first.any())
    assert (walked[1].numpy()[first.numpy()] == 0.0).all()


def test_fused_kernel_refuses_large_ranges(scenes):
    _, _, scene = scenes
    with pytest.raises(ValueError, match="instance range"):
        pallas_pt.render_sum_fused(scene, None, 4, 4, 0)


def test_renders_through_finalize_match_jax(one_torch_thread, scenes):
    """The meshviewer's Whitted rig on the port's own instanced build
    against the JAX meshviewer on the same meshes baked flat (the JAX
    Whitted integrator shades an instanced smooth mesh with its
    object-space normal, whitted.py:71-94; the port takes it back to
    world, as both path engines do), and against the port's flat build;
    the path-traced launch against the JAX instanced scene's."""
    jhost, jscene, _ = scenes
    host, scene = build(Scene, "cpu")
    assert set(scene.instance_clusters) == {(0, 960)}
    jflat, _ = build(JScene, flat=True)
    flat, _ = build(Scene, "cpu", flat=True)
    cam = JCamera(eye=(0.0, 3.0, -12.0), lookat=(0.0, 0.0, 0.0),
                  fov_y=45.0)
    for sc in (host, flat):
        sc.add_camera(Camera(**dataclasses.asdict(cam)))
    jflat.add_camera(cam)
    img, _, rays = meshviewer.render(None, 24, 24, samples=1, max_depth=2,
                                     scene=host, device="cpu")
    own_flat, _, flat_rays = meshviewer.render(None, 24, 24, samples=1,
                                               max_depth=2, scene=flat,
                                               device="cpu")
    ref, _ = jmeshviewer.render(None, 24, 24, samples=1, max_depth=2,
                                scene=jflat)
    for other, what in ((np.asarray(ref), "jax flat"),
                        (own_flat.numpy(), "port flat")):
        ok = np.isclose(img.numpy(), other, atol=2e-3, rtol=1e-3).all(-1)
        assert int((~ok).sum()) <= 2, what
    assert int(rays) == int(flat_rays) and img.numpy().mean() > 0.01
    w = h = 16
    pcam = host.default_camera(w, h)
    film, rays = engine.render_accumulate(
        scene, pcam.params("cpu"), Film.create(h, w, "cpu"), w, h,
        samples_per_launch=2, max_depth=3)
    jfilm, jrays = jengine.render_accumulate(
        jscene, cam.params(), JFilm.create(h, w), w, h,
        samples_per_launch=2, max_depth=3)
    ok = np.isclose(film.accum.numpy(), np.asarray(jfilm.accum), atol=2e-3,
                    rtol=1e-3).all(-1)
    assert int((~ok).sum()) <= 2
    assert int(rays) == int(jrays) > 0
