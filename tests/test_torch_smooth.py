"""Smooth normals on small meshes in the port (accel/geometry.py's
shade_plane / shading_frame and the engine's shading-frame epilogue) and
the fused kernel's smooth-normal variant (3') on the CPU, against the JAX
package: its shading_frame, its XLA engine and its Pallas megakernel in
interpret mode.

The scenes: tests/test_fused_textures.py:115-134's smooth quad (a floor
and a tilted quad with per-vertex normals), knot_scene(8, 6) (96 smooth
tube triangles and a 2-triangle floor, no cluster table), the prims scene
over a smooth floor (custom-prim hits keep their analytic normal) and the
instanced cube with per-vertex normals on the cube and none on the floor
(the epilogue's instance row rule, and its face-normal fallback).

The port follows the XLA engine's shading_frame (w n0 + u n1 + v n2, length
> 1e-6, divided by max(length, 1e-12)); the Pallas kernel interpolates in
delta form with an rsqrt (pallas_pt.py:1006-1016). Bars: the frame within
1e-6; traced-ray counts equal and radiance within atol 3e-3 / rtol 1e-3
against both reference paths (tests/test_fused_kernel.py:271, 292)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from optix_raytracer_tpu.accel import primitives as jprim
from optix_raytracer_tpu.accel.geometry import (
    build_triangle_geometry as jgeom, shading_frame as jframe)
from optix_raytracer_tpu.core.camera import Camera as JCamera
from optix_raytracer_tpu.scene import builtins as jb
from optix_raytracer_tpu.scene.device_scene import (
    make_device_scene as jmake_scene)
from optix_raytracer_tpu.shade.lights import ParallelogramLight as JLight
from optix_raytracer_tpu.wavefront import engine as jengine
from optix_raytracer_tpu.wavefront import pallas_pt as jpt
from optix_raytracer_tpu_torch import kernels
from optix_raytracer_tpu_torch.accel.geometry import (build_triangle_geometry,
                                                      shade_plane,
                                                      shading_frame)
from optix_raytracer_tpu_torch.scene import builtins as tb
from optix_raytracer_tpu_torch.wavefront import engine, pallas_pt

from torch_parity import (instanced_cube, one_torch_thread,  # noqa: F401
                          torch_cam, torch_scene)

BARS = dict(atol=3e-3, rtol=1e-3)
FRAME_TOL = dict(atol=1e-6, rtol=1e-6)


def _cam(eye, lookat, fov):
    def make(w, h):
        return JCamera(eye=eye, lookat=lookat, up=(0, 1, 0), fov_y=fov,
                       aspect=w / h).params()
    return make


def smooth_quad():
    """tests/test_fused_textures.py:115-134: a floor with up normals and a
    tilted quad whose four vertex normals lean off its face."""
    s = 3.0
    verts = np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s],
                      [-1, 0, -0.5], [1, 0, -0.5],
                      [1, 1.6, -0.5], [-1, 1.6, -0.5]], np.float32)
    idx = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7]], np.int32)
    normals = np.zeros((8, 3), np.float32)
    normals[:4] = (0, 1, 0)
    nr = np.array([0.3, 0.2, -0.93], np.float32)
    normals[4:] = nr / np.linalg.norm(nr)
    return jmake_scene(verts, idx, np.zeros(4, np.int32),
                       [{"kind": 0, "base_color": (0.7, 0.5, 0.4)}],
                       normals=normals,
                       area_light=JLight.make((-1.0, 3.0, -1.0), (2, 0, 0),
                                              (0, 0, 2), (8.0, 8.0, 8.0)))


def smooth_prims():
    """The prims scene (bench.py:167-190, no glass) over a floor with
    tilted vertex normals."""
    verts, idx = tb.prims_floor()
    normals = np.tile(np.array([[0.2, 1.0, -0.1]], np.float32), (4, 1))
    return jmake_scene(verts, idx, np.zeros(2, np.int32),
                       tb.PRIMS_MATERIALS[:3], normals=normals,
                       area_light=JLight.make(*tb.PRIMS_LIGHT),
                       prims=jprim.make_prims(tb.prims_list(False)))


# --- the shading frame --------------------------------------------------------

def test_shading_frame_matches_jax():
    """Position, face normal and interpolated shading normal of random hits
    on a mesh whose corner normals are random, opposed (they cancel at the
    centroid) or zero (the face-normal fallback)."""
    rng = np.random.default_rng(3)
    m = 60
    verts = rng.normal(size=(3 * m, 3)).astype(np.float32)
    idx = np.arange(3 * m, dtype=np.int32).reshape(m, 3)
    normals = rng.normal(size=(3 * m, 3)).astype(np.float32)
    normals[30:45] = 0.0                                   # triangles 10-14
    normals[46] = -normals[45]                             # triangle 15:
    normals[47] = 0.0                                      # cancels at u=.5
    g = build_triangle_geometry(verts, idx, "cpu", normals=normals)
    jg = jgeom(verts, idx, normals=normals)
    pid = rng.integers(0, m, 400).astype(np.int32)
    uv = rng.uniform(0, 0.5, (400, 2)).astype(np.float32)
    pid[:3], uv[:3] = 15, (0.5, 0.0)
    own = shading_frame(g, torch.as_tensor(pid), torch.as_tensor(uv))
    ref = jframe(jg, jnp.asarray(pid), jnp.asarray(uv))
    for k in ("position", "normal", "shading_normal"):
        np.testing.assert_allclose(own[k].numpy(), np.asarray(ref[k]),
                                   **FRAME_TOL, err_msg=k)
    fallback = (pid >= 10) & (pid < 15)
    np.testing.assert_array_equal(own["shading_normal"].numpy()[fallback],
                                  own["normal"].numpy()[fallback])
    np.testing.assert_array_equal(own["shading_normal"].numpy()[:3],
                                  own["normal"].numpy()[:3])
    # the plane's columns: one gather of 21 floats per hit
    plane = shade_plane(g)
    assert plane.shape == (m, 21)
    np.testing.assert_array_equal(plane[:, 12:].numpy(),
                                  normals[idx].reshape(m, 9))


# --- the engine ----------------------------------------------------------------

_SCENES = {
    # name: (JAX scene, camera, size, depth)
    "quad": (smooth_quad, _cam((0, 1.5, -4.5), (0, 0.6, 0), 45.0), 24, 3),
    "knot": (lambda: jb.knot_scene(8, 6),
             lambda w, h: jb.knot_camera(w, h).params(), 24, 3),
    "prims": (smooth_prims, lambda w, h: jb_prims_camera(w, h), 24, 3),
    "instanced": (lambda: instanced_cube("jax", smooth=True),
                  _cam((0, 2.5, -5.0), (0, 0.3, 0), 45.0), 24, 3),
}


def jb_prims_camera(w, h):
    c = tb.prims_camera(w, h)
    return JCamera(eye=c.eye, lookat=c.lookat, up=c.up, fov_y=c.fov_y,
                   aspect=c.aspect).params()


@pytest.mark.parametrize("name", list(_SCENES))
def test_render_sample_matches_jax(name):
    """engine.render_sample with the shading-frame epilogue against the XLA
    render_sample, 24², depth 3, on each smooth scene."""
    make, camera, size, depth = _SCENES[name]
    js = make()
    ts = torch_scene(js)
    assert ts.geom.smooth and not ts.has_clusters
    jcam = camera(size, size)
    ref, ref_count = jengine.render_sample(js, jcam, size, size, 1,
                                           max_depth=depth, chunk_size=None)
    out, count = engine.render_sample(ts, torch_cam(jcam), size, size, 1,
                                      max_depth=depth)
    assert int(count) == int(float(ref_count))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **BARS)
    assert float(out.max()) > 0.05


def test_epilogue_changes_the_normals():
    """The smooth quad renders differently with and without its shading
    normals (the epilogue is on), and the instanced smooth cube's
    epilogue reads its instance's inverse (row ids)."""
    ts = torch_scene(smooth_quad())
    flat = torch_scene(smooth_quad())
    flat.geom.smooth = False
    cam = torch_cam(_SCENES["quad"][1](16, 16))
    a, _ = engine.render_sample(ts, cam, 16, 16, 0, max_depth=2)
    b, _ = engine.render_sample(flat, cam, 16, 16, 0, max_depth=2)
    assert float((a - b).abs().max()) > 1e-2
    inst = torch_scene(instanced_cube("jax", smooth=True))
    assert inst.instances.row_ids and inst.has_instances


def test_own_small_knot_matches_jax():
    """The port's own knot_scene(8, 6): 98 smooth triangles, no cluster
    table, the corner normals bit-equal to the reference's, and its render
    equal to the handed-over scene's within the bars."""
    own = tb.knot_scene(8, 6, device="cpu")
    js = jb.knot_scene(8, 6)
    assert own.num_triangles == 98 and own.geom.smooth and not own.has_clusters
    np.testing.assert_array_equal(own.geom.corner_normal.numpy(),
                                  np.asarray(js.geom.corner_normal))
    cam = tb.knot_camera(16, 16).params("cpu")
    a, ca = engine.render_sample(own, cam, 16, 16, 2, max_depth=2)
    b, cb = engine.render_sample(torch_scene(js), cam, 16, 16, 2, max_depth=2)
    assert int(ca) == int(cb)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **BARS)


def test_fused_plain_matches_megakernel():
    """render_sum_fused on CPU tensors (the plain version of the smooth
    variant) against the Pallas megakernel with smooth=True in interpret
    mode (its unrolled winner selects and delta-form interpolation), on the
    smooth quad, 16², spl 1, depth 2."""
    js = smooth_quad()
    ts = torch_scene(js)
    jcam = _SCENES["quad"][1](16, 16)
    ref, ref_count = jpt.render_sum_fused(js, jcam, 16, 16, 0,
                                          samples_per_launch=1, max_depth=2,
                                          interpret=True)
    out, count = pallas_pt.render_sum_fused(ts, torch_cam(jcam), 16, 16, 0,
                                            samples_per_launch=1,
                                            max_depth=2)
    assert int(count) == int(float(ref_count))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **BARS)


def test_smooth_knot_variant():
    """knot_scene(16, 15), chip_smoke's smooth knot: 2 * 16 * 15 = 480 tube
    triangles and 2 floor triangles, under the 512 cap, no cluster table;
    it takes the smooth variant, and its corner plane is [482, 9]."""
    scene = tb.knot_scene(16, 15, device="cpu")
    assert scene.num_triangles == 482 <= pallas_pt.MAX_FUSED_TRIS
    assert scene.geom.smooth and not scene.has_clusters
    assert pallas_pt.fused_variant(scene) == (False, False, False, "smooth")
    assert kernels.pt_fused_name(*pallas_pt.fused_variant(scene)) == (
        "pt_fused_smooth")
    assert scene.geom.corner_normal.reshape(482, 9).shape == (482, 9)
    assert kernels.pt_fused_name(False, True, False, "smooth") == (
        "pt_fused_smooth_pbr")
    with pytest.raises(ValueError):
        kernels.pt_fused_name(False, False, False, "textured")
