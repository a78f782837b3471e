"""The port's Whitted integrator and what it needs (the light table, the
Whitted material planes, Film.accumulate, the host Scene's lights, bounds
and camera, the Whitted and meshviewer apps) against the JAX package on the
CPU.

Bars: sample_light's RNG words equal and wi / dist / radiance within 1e-6
relative; the material planes and the film bit-equal; images within atol
2e-3 / rtol 1e-3 (tests/test_fused_kernel.py), where a pixel outside them is
counted as branch-flipped and the count is bounded per scene (FLIPS). Such a
pixel is a lane whose branch turned on an ulp: the phong lobe
(`torch.pow` against `jnp.power`), a volumetric light's jitter (`** (1/3)`),
and FMAs XLA:CPU contracts inside `jit` round apart from the port's eager
ops, which can flip a glass lane's `refr_ok` or `u < fresnel`, or a
grazing hit. The counts seen: 0 on every scene here.

The JAX side runs on the CPU as its own tests run it: brute force, and on
the 562-triangle knot rig (past 512 triangles, so the port takes its
cluster path) the JAX BVH traversal. About 95 s on one worker with a cold
JAX compile cache (55 s warm), most of it the JAX compiles of
render_whitted_sample (one per scene and frame).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_raytracer_tpu.accel import primitives as jprim
from optix_raytracer_tpu.apps import meshviewer as jmeshviewer
from optix_raytracer_tpu.apps import whitted as jwhitted_app
from optix_raytracer_tpu.core import film as jfilm
from optix_raytracer_tpu.scene import builtins as jbuiltins
from optix_raytracer_tpu.scene.device_scene import (
    make_device_scene as jmake_device_scene)
from optix_raytracer_tpu.scene.scene import Scene as JScene
from optix_raytracer_tpu.shade import lights as jlights
from optix_raytracer_tpu.shade import materials as jmats
from optix_raytracer_tpu.wavefront import whitted as jwhitted
from optix_raytracer_tpu_torch.accel import primitives as tprim
from optix_raytracer_tpu_torch.apps import meshviewer as tmeshviewer
from optix_raytracer_tpu_torch.apps import whitted as twhitted_app
from optix_raytracer_tpu_torch.core import film as tfilm
from optix_raytracer_tpu_torch.scene import builtins as tbuiltins
from optix_raytracer_tpu_torch.scene.device_scene import make_device_scene
from optix_raytracer_tpu_torch.scene.scene import Scene
from optix_raytracer_tpu_torch.shade import lights as tlights
from optix_raytracer_tpu_torch.shade import materials as tmats
from optix_raytracer_tpu_torch.tools.whitted_probe import recorded_queries
from optix_raytracer_tpu_torch.wavefront import whitted as twhitted

from torch_parity import jax_native_sah, one_torch_thread  # noqa: F401

ATOL, RTOL = 2e-3, 1e-3
# Branch-flipped pixels allowed per image (see the module docstring).
FLIPS = 2
KINDS = (tlights.POINT, tlights.AMBIENT, tlights.DIRECTIONAL,
         tlights.PARALLELOGRAM, tlights.VOLUMETRIC)


def _flipped(out, ref):
    """Pixels [H, W, 3] with a channel outside the image bars."""
    ok = np.isclose(out, ref, atol=ATOL, rtol=RTOL)
    return int((~ok.all(axis=-1)).sum())


def _assert_image(out, ref, what):
    assert out.shape == ref.shape and np.isfinite(out).all(), what
    n = _flipped(out, ref)
    assert n <= FLIPS, (f"{what}: {n} pixels outside atol {ATOL} / rtol "
                        f"{RTOL}, max abs diff {np.abs(out - ref).max()}")


def _light(kind, falloff, rng):
    return {"kind": kind, "position": tuple(rng.uniform(-3, 3, 3)),
            "color": tuple(rng.uniform(0.2, 2.0, 3)), "falloff": falloff,
            "radius": float(rng.uniform(0.1, 0.8))}


@pytest.mark.parametrize("kind,falloff",
                         [(k, f) for k in KINDS for f in (0, 1, 2)]
                         + [(None, 0)])
def test_sample_light_matches_jax(kind, falloff):
    """Light 1 of a three-light table (light 0 of the empty table, a
    zero-color POINT light at the origin) from 512 random hit points."""
    rng = np.random.default_rng(17 + 3 * (kind or 0) + falloff)
    lights = ([] if kind is None else
              [_light(tlights.POINT, 1, rng), _light(kind, falloff, rng),
               _light(tlights.VOLUMETRIC, 2, rng)])
    i = 0 if kind is None else 1
    hit = rng.uniform(-4, 4, (512, 3)).astype(np.float32)
    words = rng.integers(0, 2 ** 32, 512, dtype=np.int64)
    jt = jlights.LightTable.make(lights)
    tt = tlights.LightTable.make(lights, "cpu")
    assert tt.num == jt.num == max(len(lights), 1)
    ref = jlights.sample_light(jt, i, jnp.asarray(hit),
                               jnp.asarray(words.astype(np.uint32)))
    out = tlights.sample_light(tt, i, torch.as_tensor(hit),
                               torch.as_tensor(words))
    np.testing.assert_array_equal(out[4].numpy(),
                                  np.asarray(ref[4]).astype(np.int64))
    for a, b, what in zip(out[:3], ref[:3], ("wi", "dist", "radiance")):
        a, b = a.numpy(), np.broadcast_to(np.asarray(b), a.shape)
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * np.abs(
            b).max(), err_msg=what)
    np.testing.assert_array_equal(out[3].numpy(),
                                  np.broadcast_to(np.asarray(ref[3]),
                                                  out[3].shape))
    if kind is None:
        assert float(tt.color.abs().sum()) == 0.0


def test_uniform_sample_sphere_matches_jax():
    from optix_raytracer_tpu.shade.sampling import uniform_sample_sphere as j
    from optix_raytracer_tpu_torch.shade.sampling import (
        uniform_sample_sphere as t)
    u = np.random.default_rng(3).random((2, 4096)).astype(np.float32)
    out = t(torch.as_tensor(u[0]), torch.as_tensor(u[1])).numpy()
    np.testing.assert_allclose(out, np.asarray(j(jnp.asarray(u[0]),
                                                 jnp.asarray(u[1]))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)


MIXED_MATERIALS = [
    {"kind": tmats.CHECKER, "base_color": (0.8, 0.3, 0.15),
     "checker1": (0.9, 0.85, 0.05), "checker_scale": 6.0,
     "specular": (0.2, 0.2, 0.2), "phong_exp": 24.0, "kr": (0.1, 0.1, 0.1)},
    {"kind": tmats.PHONG, "base_color": (0.1, 0.2, 0.7),
     "specular": (0.5, 0.5, 0.5), "phong_exp": 64.0,
     "kr": (0.25, 0.25, 0.25)},
    {"kind": tmats.GLASS, "ior": 1.45, "kr": (0.9, 0.9, 0.9)},
    {"kind": tmats.PBR, "base_color": (0.9, 0.9, 0.9), "metallic": 1.0,
     "roughness": 0.02, "kr": (0.8, 0.8, 0.8)},                 # mirror
    {"kind": tmats.PBR, "base_color": (0.7, 0.5, 0.3), "metallic": 0.6,
     "roughness": 0.4},                                          # rough PBR
    {"kind": tmats.DIFFUSE, "base_color": (0.6, 0.6, 0.6),
     "emission": (0.3, 0.2, 0.1)},
]


def test_material_planes_match_jax():
    for materials in (MIXED_MATERIALS, tbuiltins.WHITTED_MATERIALS,
                      tbuiltins.KNOT_MATERIALS, []):
        ref = jmats.make_material_table(materials)
        out = tmats.make_material_table(materials, "cpu")
        for key in ("kind", "base_color", "emission", "metallic",
                    "roughness", "ior", "kr", "specular", "phong_exp",
                    "checker1", "checker_scale"):
            np.testing.assert_array_equal(getattr(out, key).numpy(),
                                          np.asarray(getattr(ref, key)),
                                          err_msg=key)
    # the path tracer's gather reads the fields it read before
    g = tmats.gather(out, torch.zeros(4, dtype=torch.int32))
    assert set(g) == set(tmats.PT_FIELDS) and "phong_exp" not in g
    g = tmats.gather(out, torch.zeros(4, dtype=torch.int32), twhitted.FIELDS)
    assert g["phong_exp"].shape == (4,) and g["checker1"].shape == (4, 3)


@pytest.mark.parametrize("variance", [False, True])
def test_film_accumulate_matches_jax(variance):
    rng = np.random.default_rng(5)
    jf = jfilm.Film.create(6, 7, track_variance=variance)
    tf = tfilm.Film.create(6, 7, "cpu", track_variance=variance)
    for _ in range(3):
        rad = rng.uniform(-0.1, 3.0, (6, 7, 3)).astype(np.float32)
        jf = jf.accumulate(jnp.asarray(rad))
        tf = tf.accumulate(torch.as_tensor(rad))
        np.testing.assert_array_equal(tf.accum.numpy(), np.asarray(jf.accum))
        assert int(tf.subframe) == int(jf.subframe)
        if variance:
            np.testing.assert_array_equal(tf.sq.numpy(), np.asarray(jf.sq))
            assert int(tf.launches) == int(jf.launches)
        else:
            assert tf.sq is None and tf.launches is None


def _host_scenes():
    """The same two meshes (one with normals, one moved by a transform) and
    lights in a JAX and a port Scene."""
    rng = np.random.default_rng(11)
    verts = rng.uniform(-1, 1, (12, 3)).astype(np.float32)
    idx = np.arange(12, dtype=np.int32).reshape(4, 3)
    normals = rng.normal(size=(12, 3)).astype(np.float32)
    xf = np.eye(4, dtype=np.float32)
    xf[:3, :3] = np.diag([2.0, 0.5, 1.0])
    xf[:3, 3] = (3.0, -1.0, 0.5)
    out = []
    for cls in (JScene, Scene):
        sc = cls()
        for m in MIXED_MATERIALS[:2]:
            sc.add_material(m)
        sc.add_mesh(verts, idx, normals=normals, material=0)
        sc.add_mesh(verts[:6], idx[:2], material=1, transform=xf)
        sc.add_light({"kind": tlights.POINT, "position": (1, 4, 2),
                      "color": (1, 1, 1), "falloff": 2})
        sc.add_light({"kind": tlights.DIRECTIONAL, "direction": (0, -1, 0),
                      "color": (0.5, 0.5, 0.5)})
        out.append(sc)
    return out


def test_scene_lights_bounds_camera_match_jax():
    js, ts = _host_scenes()
    lo, hi = ts.aabb()
    jlo, jhi = js.aabb()
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    cam, jcam = ts.default_camera(64, 48), js.default_camera(64, 48)
    for key in ("eye", "lookat", "up", "fov_y", "aspect", "aperture"):
        np.testing.assert_array_equal(np.asarray(getattr(cam, key)),
                                      np.asarray(getattr(jcam, key)))
    params, jparams = cam.params("cpu"), jcam.params()
    for key in ("eye", "U", "V", "W"):
        np.testing.assert_array_equal(params[key].numpy(),
                                      np.asarray(jparams[key]))
    rig = tmeshviewer.headlight_rig(cam)
    for own, other in ((None, None), (rig, rig)):
        t = ts.finalize("cpu", lights=own)
        j = js.finalize(lights=other)
        for key in ("kind", "position", "color", "falloff", "radius"):
            np.testing.assert_array_equal(getattr(t.lights, key).numpy(),
                                          np.asarray(getattr(j.lights, key)))
        np.testing.assert_allclose(t.geom.tri_consts.numpy(),
                                   np.asarray(j.geom.tri_consts),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(t.tri_mat.numpy(),
                                      np.asarray(j.tri_mat))
    assert t.lights.num == 2 and ts.finalize("cpu").lights.num == 2
    assert Scene().finalize("cpu").lights.num == 1
    # the loaders are ported: a missing model raises as the reference's
    # load does (tests/test_torch_scene_load.py renders loaded models)
    from optix_raytracer_tpu.scene.scene import Scene as JScene
    for load in (Scene.load, JScene.load):
        with pytest.raises(FileNotFoundError):
            load("no-such-model.gltf")
    with pytest.raises(FileNotFoundError):
        tmeshviewer.render("no-such-model.gltf", 8, 8, device="cpu")
    with pytest.raises(FileNotFoundError):
        tmeshviewer.main(["--model", "no-such-model.gltf", "--animate", "2",
                          "--device", "cpu"])


def _mixed_scene(package, lights):
    """Five triangles (a checker floor quad, a PBR and a phong triangle, a
    mirror one) and three prims (a glass sphere, a phong sphere, an
    emissive parallelogram) under `lights`."""
    verts = np.array([[-4, 0, -4], [4, 0, -4], [4, 0, 4], [-4, 0, 4],
                      [-2, 0.2, 1], [-0.5, 2.2, 1.5], [-1, 0.2, 2.5],
                      [1.5, 0.2, 1.8], [2.8, 1.8, 2.4], [2.4, 0.2, 3.2],
                      [-3, 0.1, 3.5], [-1.5, 2.5, 3.8], [-3.2, 2.4, 3.3]],
                     np.float32)
    idx = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [7, 8, 9],
                    [10, 11, 12]], np.int32)
    tri_mat = np.array([0, 0, 4, 1, 3], np.int32)
    prims = [{"kind": tprim.SPHERE, "center": (0.3, 0.9, 0.2),
              "radius": 0.8, "mat_id": 2},
             {"kind": tprim.SPHERE, "center": (-2.0, 0.6, -0.8),
              "radius": 0.6, "mat_id": 1},
             {"kind": tprim.PARALLELOGRAM, "anchor": (1.0, 0.05, -2.5),
              "v1": (1.5, 0.0, 0.0), "v2": (0.0, 0.0, 1.0), "mat_id": 5}]
    if package == "jax":
        return jmake_device_scene(verts, idx, tri_mat, MIXED_MATERIALS,
                                  lights=lights, prims=jprim.make_prims(prims),
                                  miss_color=(0.2, 0.3, 0.5))
    return make_device_scene(verts, idx, tri_mat, MIXED_MATERIALS, "cpu",
                             lights=lights,
                             prims=tprim.make_prims(prims, "cpu"),
                             miss_color=(0.2, 0.3, 0.5))


MIXED_LIGHTS = [
    {"kind": tlights.POINT, "position": (3.0, 5.0, -2.0),
     "color": (20.0, 20.0, 18.0), "falloff": 2},
    {"kind": tlights.AMBIENT, "color": (0.1, 0.1, 0.12)},
    {"kind": tlights.DIRECTIONAL, "direction": (-0.3, -1.0, 0.4),
     "color": (0.6, 0.6, 0.5)},
    {"kind": tlights.PARALLELOGRAM, "position": (-3.0, 4.0, -1.0),
     "color": (3.0, 2.0, 2.0), "falloff": 1},
    {"kind": tlights.VOLUMETRIC, "position": (0.5, 3.5, 1.0),
     "color": (1.5, 1.5, 2.0), "falloff": 0, "radius": 0.5},
]
MIXED_CAMERA = dict(eye=(0.0, 3.0, -7.0), lookat=(0.0, 0.8, 0.5),
                    up=(0.0, 1.0, 0.0), fov_y=50.0)


def _render_pair(jscene, tscene, jcam, tcam, w, h, subframes, depth):
    """render_whitted_sample of both packages → [(port, JAX, rays)] per
    subframe."""
    out = []
    for sub in subframes:
        ref = np.asarray(jwhitted.render_whitted_sample(
            jscene, jcam, w, h, jnp.uint32(sub), max_depth=depth))
        img, rays = twhitted.render_whitted_sample(tscene, tcam, w, h, sub,
                                                   max_depth=depth)
        out.append((img.numpy(), ref, int(rays)))
    return out


def test_whitted_scene_matches_jax(one_torch_thread):
    """The Whitted scene (a degenerate triangle beside the prims: kernels
    1-2 get a one-row table), 32x24, 2 samples, depth 4."""
    w, h = 32, 24
    jcam = jbuiltins.whitted_camera(w, h).params()
    tcam = tbuiltins.whitted_camera(w, h).params("cpu")
    scene = tbuiltins.whitted_scene("cpu")
    assert scene.num_triangles == 1 and not bool(scene.geom.valid[0])
    assert scene.bf_boxes[0] is None and scene.prims.num == 3
    for img, ref, rays in _render_pair(jbuiltins.whitted_scene(), scene,
                                       jcam, tcam, w, h, (0, 1), 4):
        _assert_image(img, ref, "whitted")
        assert rays > w * h and img.mean() > 0


@pytest.mark.parametrize("lights", ["five", "none"])
def test_mixed_scene_matches_jax(one_torch_thread, lights):
    """16x16, 2 samples, depth 4: all five light kinds (and falloffs 0-2)
    on checker, phong, glass, mirror, rough PBR and emissive lanes; with no
    lights the table's one zero-color light still draws its RNG and casts
    its shadow query."""
    w = h = 16
    ls = MIXED_LIGHTS if lights == "five" else []
    cam = dict(MIXED_CAMERA, aspect=1.0)
    from optix_raytracer_tpu.core.camera import Camera as JCamera
    from optix_raytracer_tpu_torch.core.camera import Camera
    jscene, tscene = _mixed_scene("jax", ls), _mixed_scene("torch", ls)
    assert set(tscene.features) == set(jscene.features) == {"glass",
                                                            "mirror", "pbr"}
    pairs = _render_pair(jscene, tscene, JCamera(**cam).params(),
                         Camera(**cam).params("cpu"), w, h, (3, 4), 4)
    for img, ref, _ in pairs:
        _assert_image(img, ref, f"mixed {lights}")
        assert img.max() > 0.05


@pytest.fixture(scope="module")
def knot_refs(jax_native_sah):
    """Per knot mesh, the port's host Scene of knot_scene's geometry and the
    JAX meshviewer's image of the same meshes at 24x24, 1 sample, depth
    3."""
    refs = {}

    def get(segments, sides):
        if (segments, sides) not in refs:
            verts, idx, normals, tri_mat, _ = tbuiltins.knot_mesh(segments,
                                                                  sides)
            js = JScene()
            for m in tbuiltins.KNOT_MATERIALS:
                js.add_material(m)
            js.add_mesh(verts, idx, normals=normals, material=tri_mat)
            ref, _ = jmeshviewer.render(None, 24, 24, samples=1, max_depth=3,
                                        scene=js)
            refs[segments, sides] = (
                tbuiltins.knot_host_scene(segments, sides), np.asarray(ref))
        return refs[segments, sides]
    return get


@pytest.mark.parametrize("mesh,qwalk", [((20, 14), "0"), ((20, 14), "1"),
                                        ((8, 6), "0")])
def test_knot_rig_matches_jax(one_torch_thread, monkeypatch, knot_refs,
                              mesh, qwalk):
    """The meshviewer's headlight rig on a small knot against the JAX
    meshviewer (BVH traversal past 512 triangles, brute force below, on the
    CPU). knot_scene(20, 14)'s 562 triangles take the port's cluster path
    (kernels 4-6; any-hit through kernels 7-8 under ORT_QWALK=1), whose walk
    interpolates the smooth normal; knot_scene(8, 6)'s 98 take brute force
    (kernels 1-2) and the smooth-normal branch's shading_frame."""
    scene, ref = knot_refs(*mesh)
    monkeypatch.setenv("ORT_QWALK", qwalk)
    with recorded_queries() as calls:
        img, film, rays = tmeshviewer.render(None, 24, 24, samples=1,
                                             max_depth=3, scene=scene,
                                             device="cpu")
    routes = {(c["route"], c["kind"]) for c in calls}
    if mesh == (8, 6):
        assert routes == {("bf", "closest"), ("bf", "any")}
    else:
        assert ("clusters", "closest") in routes
        assert (("clusters", "any") in routes) == (qwalk == "0")
    _assert_image(img.numpy(), ref, f"knot rig {mesh} qwalk={qwalk}")
    assert int(film.subframe) == 1 and int(rays) > 0
    assert img.numpy().mean() > 0.01


def _expected_live(calls, num_lights):
    """The dead-lane rule checked on recorded queries: per bounce one
    closest query, then one any-hit query per light; a bounce's closest
    query is live exactly on the lanes whose previous closest query hit a
    material with kr > 0 (and on every lane at bounce 0), and a shadow ray
    is live only on a lane whose closest query was live."""
    per = 1 + num_lights
    assert len(calls) % per == 0
    bounces = [calls[i:i + per] for i in range(0, len(calls), per)]
    for b, group in enumerate(bounces):
        assert group[0]["kind"] == "closest"
        assert all(c["kind"] == "any" for c in group[1:])
        live = [(c["rays"].tmax > c["rays"].tmin) for c in group]
        if b == 0:
            assert bool(live[0].all())
        for sh in live[1:]:
            assert not bool((sh & ~live[0]).any())
    return [[(c["rays"].tmax > c["rays"].tmin) for c in g] for g in bounces]


def test_dead_lanes_get_empty_windows(one_torch_thread):
    """Kernels 1-2 (the Whitted scene) and the cluster walks (the knot rig)
    see a lane that has ended, and a shadow ray whose term is masked out,
    as dead (tmax 0 <= tmin): the live closest lanes of bounce b + 1 are
    the lanes that hit a reflective material at bounce b; the image is the
    JAX one (test_whitted_scene_matches_jax)."""
    w, h, depth = 24, 16, 4
    scene = tbuiltins.whitted_scene("cpu")
    cam = tbuiltins.whitted_camera(w, h).params("cpu")
    with recorded_queries() as calls:
        img, rays = twhitted.render_whitted_sample(scene, cam, w, h, 0,
                                                   max_depth=depth)
    assert {c["route"] for c in calls} == {"bf"} and len(calls) == depth * 3
    live = _expected_live(calls, scene.lights.num)
    ended = [int((~g[0]).sum()) for g in live]
    assert ended[0] == 0 and ended[1] > 0 and ended[-1] > ended[1]
    assert int(rays) == sum(int(x.sum()) for g in live for x in g)
    # a lane live at bounce b + 1 was live at bounce b
    for a, b in zip(live, live[1:]):
        assert not bool((b[0] & ~a[0]).any())

    knot = tbuiltins.knot_host_scene(20, 14)
    with recorded_queries() as calls:
        tmeshviewer.render(None, 16, 16, samples=1, max_depth=3, scene=knot,
                           device="cpu")
    assert {c["route"] for c in calls} == {"clusters"}
    live = _expected_live(calls, 2)
    assert int((~live[1][0]).sum()) > 0


def test_whitted_app_matches_jax(one_torch_thread, tmp_path):
    """apps.whitted.render(96, 72, samples=3, max_depth=4) against the JAX
    app, with the region checks of tests/test_primitives_whitted.py:90-108,
    and main() writing a .ppm with its ASCII preview."""
    img, film, rays = twhitted_app.render(96, 72, samples=3, max_depth=4,
                                          device="cpu")
    ref, jfilm_ = jwhitted_app.render(96, 72, samples=3, max_depth=4)
    img, ref = img.numpy(), np.asarray(ref)
    _assert_image(img, ref, "whitted app")
    assert int(film.subframe) == int(jfilm_.subframe) == 3
    assert np.isfinite(img).all() and (img >= 0).all()
    sky = img[2, 48]
    assert sky[2] > sky[0]
    assert img[-6:, :].reshape(-1, 3)[:, 0].mean() > 0.3
    assert img[-20:, :].mean(axis=-1).std() > 0.05
    out = tmp_path / "w.ppm"
    twhitted_app.main(["--file", str(out), "--dim", "24x16", "--samples",
                       "1", "--depth", "2", "--device", "cpu", "--ascii"])
    assert out.read_bytes().startswith(b"P6\n24 16\n255\n")


def test_textured_whitted_raises():
    """The textured lane (shade/texture.py::sample_bilinear on the atlas's
    level 0, the shading frame's normal), which raised until it was
    ported, on bench.py's textured scene at small map sizes under one point
    light: it renders the JAX package's image (8x8, depth 2, the JAX scene
    handed over)."""
    from optix_raytracer_tpu.core.camera import Camera as JCamera
    from test_torch_textures import jax_textured
    from torch_parity import torch_cam, torch_scene
    jscene = jax_textured(1.0, 1.0, sizes=(8, 4, 4, 2)).replace(
        lights=jlights.LightTable.make(MIXED_LIGHTS[:1]))
    cam = tbuiltins.textured_camera(8, 8)
    jcam = JCamera(eye=cam.eye, lookat=cam.lookat, up=cam.up,
                   fov_y=cam.fov_y, aspect=cam.aspect).params()
    scene = torch_scene(jscene)
    assert scene.has_textures and scene.textures.shape[0] == 4
    ref = np.asarray(jwhitted.render_whitted_sample(
        jscene, jcam, 8, 8, jnp.uint32(0), max_depth=2))
    img, _ = twhitted.render_whitted_sample(scene, torch_cam(jcam), 8, 8, 0,
                                            max_depth=2)
    _assert_image(img.numpy(), ref, "textured whitted")
    assert img.numpy().max() > 0
