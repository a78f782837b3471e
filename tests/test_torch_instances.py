"""The instance layer of the port (core/transforms.py, accel/tlas.py, the
Scene class, cornell_box_instanced, the instance branches of the
intersector and the engine) and the fused kernel's instance variant (3')
on the CPU, against the JAX package: its transforms, its IAS queries, its
XLA engine and its Pallas megakernel in interpret mode.

The scenes are the reference's: tests/test_fused_kernel.py:20-62's
instanced cube (two rotated cube instances, one scaled, sbt offsets 0 and
1, over a floor instance) and scene/builtins.py:87-133's instanced Cornell
box. The JAX scene is handed over (torch_parity.scene_fields), inverses
included, so both packages trace with the same bits.

Bars: transforms within 2 ulps of unit scale (atol 3e-7 on unit data, rtol
1e-6); ids, instances and material ids equal, t and normals within a few
ulps (rtol 1e-6 / atol 1e-6: XLA contracts a*b+c into FMAs, the port
rounds each product) and the barycentrics within atol 1e-5 (they come from
object-space coordinates of magnitude ~5, whose ulps they inherit);
traced-ray counts equal and radiance within atol 3e-3 / rtol 1e-3
(tests/test_fused_kernel.py:271, 292)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from optix_raytracer_tpu.accel import tlas as jtlas
from optix_raytracer_tpu.core import transforms as jxf
from optix_raytracer_tpu.core.camera import Camera as JCamera
from optix_raytracer_tpu.core.rays import Rays as JRays
from optix_raytracer_tpu.scene import builtins as jb
from optix_raytracer_tpu.wavefront import engine as jengine
from optix_raytracer_tpu.wavefront import pallas_pt as jpt
from optix_raytracer_tpu_torch import kernels
from optix_raytracer_tpu_torch.accel import tlas
from optix_raytracer_tpu_torch.core import transforms as xf
from optix_raytracer_tpu_torch.core.rays import Rays
from optix_raytracer_tpu_torch.scene import builtins as tb
from optix_raytracer_tpu_torch.scene.device_scene import (DeviceScene,
                                                          make_device_scene)
from optix_raytracer_tpu_torch.scene.scene import Scene
from optix_raytracer_tpu_torch.wavefront import engine, pallas_pt

from torch_parity import (instanced_cube, one_torch_thread,  # noqa: F401
                          torch_cam, torch_scene)

BARS = dict(atol=3e-3, rtol=1e-3)
XF_TOL = dict(atol=3e-7, rtol=1e-6)
HIT_TOL = dict(atol=1e-6, rtol=1e-6)
UV_TOL = dict(atol=1e-5, rtol=0)


def _cube_cam(w, h):
    return JCamera(eye=(0, 2.5, -5.0), lookat=(0, 0.3, 0), up=(0, 1, 0),
                   fov_y=45.0, aspect=w / h).params()


# --- transforms -------------------------------------------------------------

def _affine(rng, n):
    m = rng.normal(size=(n, 3, 4)).astype(np.float32)
    m[:, :, :3] += 2.0 * np.eye(3, dtype=np.float32)    # well conditioned
    return m


def test_transforms_match_jax():
    rng = np.random.default_rng(0)
    a, b = _affine(rng, 64), _affine(rng, 64)
    p = rng.normal(size=(64, 3)).astype(np.float32)
    ta, tb_, tp = (torch.as_tensor(x) for x in (a, b, p))
    ja, jb_, jp = (jnp.asarray(x) for x in (a, b, p))
    for own, ref in (
            (xf.identity((2,)), jxf.identity((2,))),
            (xf.from_rotation_translation(ta[:, :, :3], ta[:, :, 3]),
             jxf.from_rotation_translation(ja[:, :, :3], ja[:, :, 3])),
            (xf.translate(p), jxf.translate(p)),
            (xf.scale(np.float32(1.5)), jxf.scale(np.float32(1.5))),
            (xf.scale(p), jxf.scale(p)),
            (xf.rotate((0.3, 1.0, -0.2), 0.7), jxf.rotate((0.3, 1.0, -0.2),
                                                          0.7)),
            (xf.to_4x4(ta), jxf.to_4x4(ja))):
        np.testing.assert_array_equal(own.numpy(), np.asarray(ref))
    for own, ref in (
            (xf.compose(ta, tb_), jxf.compose(ja, jb_)),
            (xf.apply_point(ta, tp), jxf.apply_point(ja, jp)),
            (xf.apply_vector(ta, tp), jxf.apply_vector(ja, jp)),
            (xf.apply_normal(ta, tp), jxf.apply_normal(ja, jp)),
            (xf.inverse(ta), jxf.inverse(ja))):
        scale_ = np.abs(np.asarray(ref)).max()
        np.testing.assert_allclose(own.numpy() / scale_,
                                   np.asarray(ref) / scale_, **XF_TOL)
    # inverse composes to the identity, within the f32 residual of these
    # matrices (condition numbers up to ~10); normal_to_world is
    # apply_normal with the inverse handed in
    np.testing.assert_allclose(xf.compose(ta, xf.inverse(ta)).numpy(),
                               np.asarray(jxf.identity((64,))), atol=1e-5)
    np.testing.assert_array_equal(
        xf.normal_to_world(torch.linalg.inv(ta[:, :, :3]), tp).numpy(),
        xf.apply_normal(ta, tp).numpy())


# --- the instanced scenes -----------------------------------------------------

def test_cornell_box_instanced_matches_jax():
    """Geometry, material ids, ranges and sbt offsets bit-equal; the
    inverses within 1e-6 relative (jnp.linalg.inv and torch.linalg.inv may
    round apart)."""
    own, ref = tb.cornell_box_instanced("cpu"), jb.cornell_box_instanced()
    assert own.num_triangles == ref.geom.num_triangles == 22
    assert own.instances.prim_ranges == ref.instances.prim_ranges == (
        (0, 12), (12, 22), (12, 22))
    assert sum(hi - lo for lo, hi in own.instances.prim_ranges) == 32
    for name in ("tri_consts", "v0", "e1", "e2", "face_normal", "valid"):
        np.testing.assert_array_equal(getattr(own.geom, name).numpy(),
                                      np.asarray(getattr(ref.geom, name)))
    np.testing.assert_array_equal(own.tri_mat.numpy(), np.asarray(ref.tri_mat))
    for name in ("sbt_offset", "instance_id", "transform"):
        np.testing.assert_array_equal(
            getattr(own.instances, name).numpy(),
            np.asarray(getattr(ref.instances, name)))
    inv, jinv = own.instances.inv_transform.numpy(), np.asarray(
        ref.instances.inv_transform)
    np.testing.assert_allclose(inv, jinv, rtol=1e-6,
                               atol=1e-6 * np.abs(jinv).max())
    assert own.instances.row_ids and own.has_instances
    assert not own.geom.smooth and not own.has_clusters
    assert own.features == tuple(ref.features) == ()
    np.testing.assert_array_equal(own.miss_color.numpy(), 0.0)


def test_scene_matches_jax():
    """The port's Scene class against the reference's, flat (transforms
    and normals baked into world space) and two-level (the instanced cube:
    an unreferenced mesh gets an identity instance)."""
    from optix_raytracer_tpu.scene.scene import Scene as JScene
    rng = np.random.default_rng(4)
    pos = rng.normal(size=(9, 3)).astype(np.float32)
    idx = np.arange(9, dtype=np.int32).reshape(3, 3)
    nrm = rng.normal(size=(9, 3)).astype(np.float32)
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = np.asarray(jxf.rotate((0, 1, 1), 0.4))[:, :3] * 1.5
    t[:3, 3] = (1.0, -2.0, 0.5)
    built = []
    for cls in (Scene, JScene):
        sc = cls()
        sc.add_material({"kind": 0})
        sc.add_material({"kind": 0, "base_color": (0.1, 0.2, 0.3)})
        sc.add_mesh(pos, idx, normals=nrm, material=[0, 1, 1], transform=t)
        sc.add_mesh(pos[:3] + 3.0, idx[:1], material=1)
        built.append(sc.finalize("cpu") if cls is Scene else sc.finalize())
    own, ref = built
    assert own.geom.smooth and ref.geom.smooth
    for name in ("v0", "e1", "e2", "corner_normal"):
        np.testing.assert_array_equal(getattr(own.geom, name).numpy(),
                                      np.asarray(getattr(ref.geom, name)))
    np.testing.assert_array_equal(own.tri_mat.numpy(), np.asarray(ref.tri_mat))
    own, ref = instanced_cube("torch"), instanced_cube("jax")
    np.testing.assert_array_equal(own.geom.tri_consts.numpy(),
                                  np.asarray(ref.geom.tri_consts))
    assert own.instances.prim_ranges == ref.instances.prim_ranges
    np.testing.assert_array_equal(own.instances.sbt_offset.numpy(),
                                  np.asarray(ref.instances.sbt_offset))


def test_unported_parts_raise():
    sc = Scene()
    # the loaders are ported: a missing model raises FileNotFoundError
    with pytest.raises(FileNotFoundError):
        Scene.load("no-such-model.gltf")
    # lights are ported: add_light keeps a copy of the dict
    light = {"kind": 1, "color": (0.2, 0.2, 0.2)}
    sc.add_light(light)
    assert sc.lights == [light] and sc.lights[0] is not light
    # textures are ported: add_texture stores the image and returns its id
    assert sc.add_texture(np.zeros((2, 2, 3))) == 0 and len(sc.textures) == 1
    sc.textures.clear()
    # an instanced mesh past 512 triangles gets its own cluster table
    # (tests/test_torch_instanced_clusters.py holds its queries)
    verts, idx, normals = tb.trefoil_mesh(20, 14)      # 560 triangles
    sc.add_material({"kind": 0})
    sc.add_mesh(verts, idx, normals=normals)
    sc.add_instance(0)
    scene = sc.finalize("cpu")
    assert list(scene.instance_clusters) == [(0, 560)]
    assert scene.bf_boxes == (None,)
    # an sbt offset past the material table
    v, f = tb.prims_floor()
    table = tlas.make_instances([np.eye(4)], "cpu", sbt_offsets=[1],
                                prim_ranges=[(0, 2)])
    with pytest.raises(ValueError, match="sbt"):
        make_device_scene(v, f, np.zeros(2, np.int32), [{"kind": 0}], "cpu",
                          instances=table)


# --- the IAS queries ----------------------------------------------------------

def _cube_rays(n=3000, seed=5):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) + 0.2
    target = rng.uniform(-1.6, 1.6, (n, 3)).astype(np.float32)
    target[:, 1] = rng.uniform(-0.2, 1.2, n)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rng.choice([1e16, 3.0, 6.0], n).astype(np.float32)
    tmax[::9] = 0.0
    return o, d.astype(np.float32), np.full(n, 1e-3, np.float32), tmax


def test_intersect_instances_match_tlas():
    """Closest hit and occlusion through the instances against tlas on the
    same handed-over scene: hit ids, instances and material ids (with the
    sbt offset) equal, t / normal / uv within a few ulps, occlusion equal."""
    js = instanced_cube("jax")
    ts = torch_scene(js)
    arrs = _cube_rays()
    own = tlas.intersect_instances(ts.geom, ts.instances,
                                   Rays(*map(torch.as_tensor, arrs)),
                                   tri_mat=ts.tri_mat)
    ref = jtlas.intersect_instances(js.geom, js.instances,
                                    JRays(*map(jnp.asarray, arrs)),
                                    tri_mat=js.tri_mat)
    for k in ("prim_id", "inst_id", "mat_id"):
        np.testing.assert_array_equal(getattr(own, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)
    hit = own.prim_id.numpy() >= 0
    inst = own.inst_id.numpy()
    assert hit.sum() > 500 and (~hit).sum() > 300
    assert all((inst == i).sum() > 50 for i in range(3))
    assert (own.mat_id.numpy()[inst == 1] == 1).all()     # sbt offset 1
    for k, tol in (("t", HIT_TOL), ("normal", HIT_TOL), ("uv", UV_TOL)):
        np.testing.assert_allclose(getattr(own, k).numpy(),
                                   np.asarray(getattr(ref, k)), **tol,
                                   err_msg=k)
    occ = tlas.intersect_instances_any(ts.geom, ts.instances,
                                       Rays(*map(torch.as_tensor, arrs)))
    jocc = jtlas.intersect_instances_any(js.geom, js.instances,
                                         JRays(*map(jnp.asarray, arrs)))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    np.testing.assert_array_equal(occ.numpy(), hit)


def test_slice_geometry_is_a_contiguous_view():
    ts = tb.cornell_box_instanced("cpu")
    sub = tlas.slice_geometry(ts.geom, 12, 22)
    assert sub.num_triangles == 10 and sub.tri_consts.is_contiguous()
    assert sub.tri_consts.data_ptr() == ts.geom.tri_consts[12].data_ptr()
    assert tlas.instance_ranges(ts.instances, ts.num_triangles) == (
        (0, 12), (12, 22), (12, 22))


# --- the engine ----------------------------------------------------------------

_RENDERS = {
    # name: (JAX scene, camera, size, depth, subframes)
    "cube": (lambda: instanced_cube("jax"), _cube_cam, 24, 3, (0, 1)),
    "cornell": (jb.cornell_box_instanced,
                lambda w, h: jb.cornell_camera(w, h).params(), 16, 2, (0,)),
}


@pytest.mark.parametrize("name", list(_RENDERS))
def test_render_sample_matches_jax(name):
    """engine.render_sample on the handed-over scene against the XLA
    render_sample: the instanced cube at 24², depth 3, two subframes; the
    instanced Cornell at 16², depth 2."""
    make, camera, size, depth, subs = _RENDERS[name]
    js = make()
    ts = torch_scene(js)
    assert ts.has_instances and ts.instances.num == 3
    jcam = camera(size, size)
    for sub in subs:
        ref, ref_count = jengine.render_sample(js, jcam, size, size, sub,
                                               max_depth=depth,
                                               chunk_size=None)
        out, count = engine.render_sample(ts, torch_cam(jcam), size, size,
                                          sub, max_depth=depth)
        assert int(count) == int(float(ref_count))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **BARS)
        assert float(out.max()) > 0.05


def test_own_instanced_cornell_renders_like_handed_over():
    """The port's own cornell_box_instanced (its own inverses) renders the
    handed-over scene's image within the bars, with the same ray count."""
    js = jb.cornell_box_instanced()
    cam = tb.cornell_camera(16, 16).params("cpu")
    a, ca = engine.render_sample(tb.cornell_box_instanced("cpu"), cam, 16, 16,
                                 3, max_depth=2)
    b, cb = engine.render_sample(torch_scene(js), cam, 16, 16, 3, max_depth=2)
    assert int(ca) == int(cb)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **BARS)


def test_fused_plain_matches_megakernel():
    """render_sum_fused on CPU tensors (the plain version of the instance
    variant) against the Pallas megakernel with inst_ranges in interpret
    mode: the instanced Cornell, 16², spl 1, depth 2."""
    js = jb.cornell_box_instanced()
    ts = torch_scene(js)
    jcam = jb.cornell_camera(16, 16).params()
    ref, ref_count = jpt.render_sum_fused(js, jcam, 16, 16, 2,
                                          samples_per_launch=1, max_depth=2,
                                          interpret=True)
    out, count = pallas_pt.render_sum_fused(ts, torch_cam(jcam), 16, 16,
                                            torch.tensor(2),
                                            samples_per_launch=1,
                                            max_depth=2)
    assert int(count) == int(float(ref_count))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **BARS)


def test_pack_instances_and_variant():
    """pack_instances and fused_inst_ranges equal the reference's; the
    instanced Cornell takes the instance variant's Cornell instantiation."""
    js = jb.cornell_box_instanced()
    ts = torch_scene(js)
    np.testing.assert_array_equal(pallas_pt.pack_instances(ts.instances)
                                  .numpy(),
                                  np.asarray(jpt.pack_instances(js.instances)))
    assert pallas_pt.fused_inst_ranges(ts) == jpt.fused_inst_ranges(js)
    assert pallas_pt.fused_variant(ts) == (False, False, False, "inst")
    assert kernels.pt_fused_name(*pallas_pt.fused_variant(ts)) == (
        "pt_fused_inst")
    assert pallas_pt.pack_instances(tb.cornell_box("cpu").instances).shape == (
        1, 16)


# --- the fused-kernel rule -----------------------------------------------------

def _many_instances(n, tris_each):
    """n identity instances of a mesh of `tris_each` triangles."""
    verts, idx, _ = tb.quads_to_triangles([(q, 0) for q, _ in
                                           tb._CORNELL_QUADS[:1]])
    reps = -(-tris_each // 2)
    sc = Scene()
    sc.add_material({"kind": 0})
    sc.add_mesh(np.tile(verts, (reps, 1)),
                (idx[None] + 4 * np.arange(reps)[:, None, None]).reshape(
                    -1, 3)[:tris_each])
    for _ in range(n):
        sc.add_instance(0)
    return sc.finalize("cpu")


def _smooth_instanced():
    return torch_scene(instanced_cube("jax", smooth=True))


@pytest.mark.parametrize("case,expected", [
    ("cornell_instanced", True), ("smooth_knot", True), ("cube", True),
    ("32_instances", True), ("33_instances", False), ("ranges_513", False),
    ("instanced_smooth", False)])
def test_use_fused_rule(monkeypatch, case, expected):
    """engine._use_fused with instances (engine.py:803-812): on a CUDA
    device at most 32 instances whose ranges sum to at most 512 triangles,
    flat-shaded only; the 482-triangle smooth knot (no cluster table) is
    fused too."""
    scene = {"cornell_instanced": lambda: tb.cornell_box_instanced("cpu"),
             "smooth_knot": lambda: tb.knot_scene(16, 15, device="cpu"),
             "cube": lambda: instanced_cube("torch"),
             "32_instances": lambda: _many_instances(32, 16),
             "33_instances": lambda: _many_instances(33, 2),
             "ranges_513": lambda: _many_instances(3, 171),
             "instanced_smooth": _smooth_instanced}[case]()
    assert not engine._use_fused(scene, "auto")      # CPU: the wavefront
    monkeypatch.setattr(DeviceScene, "device",
                        property(lambda self: torch.device("cuda")))
    assert engine._use_fused(scene, "auto") is expected
    assert engine._use_fused(scene, "fused")


def test_fused_auto_matches_wavefront_on_cpu():
    """On the CPU, impl="fused" (the plain version) and impl="wavefront"
    give the same film on the instanced Cornell."""
    from optix_raytracer_tpu_torch.core.film import Film
    scene = tb.cornell_box_instanced("cpu")
    cam = tb.cornell_camera(8, 6).params("cpu")
    films = [engine.render_accumulate(scene, cam, Film.create(6, 8, "cpu"),
                                      8, 6, samples_per_launch=2, max_depth=3,
                                      impl=impl)
             for impl in ("fused", "wavefront")]
    np.testing.assert_array_equal(films[0][0].accum.numpy(),
                                  films[1][0].accum.numpy())
    assert int(films[0][1]) == int(films[1][1]) > 48
