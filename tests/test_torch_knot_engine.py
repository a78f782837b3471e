"""The port's large-mesh engine paths (sample-major launches and the
coherence-sorted sequential loop over the cluster traversal) against the JAX
engine on the CPU, on the knot scene (knot_scene(20, 14): 562 smooth
triangles, 5 clusters).

The JAX engine takes its cluster path only on a TPU; here it is forced:
`wavefront.intersect._use_clusters` returns True and the cluster queries run
their Pallas kernels in interpret mode, with one 256-ray block per grid step
(GROUPS = 1, see test_torch_clusters.py). Without that the JAX engine would
take brute force plus the shading_frame epilogue, whose normals differ from
the walk's in-kernel interpolation. Nothing in the JAX package changes.

Bars (test_fused_kernel.py): traced-ray counts equal, radiance within
atol 2e-3 / rtol 1e-3.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from optix_raytracer_tpu.accel import clusters as jcl
from optix_raytracer_tpu.core import film as jfilm
from optix_raytracer_tpu.scene import builtins as jbuiltins
from optix_raytracer_tpu.wavefront import engine as jengine
from optix_raytracer_tpu.wavefront import intersect as jintersect
from optix_raytracer_tpu_torch.accel import clusters as tcl
from optix_raytracer_tpu_torch.core import rng as trng
from optix_raytracer_tpu_torch.core.film import Film
from optix_raytracer_tpu_torch.scene.builtins import knot_camera, knot_scene
from optix_raytracer_tpu_torch.wavefront import engine

from torch_parity import (jax_native_sah, one_torch_thread,  # noqa: F401
                          torch_cam, torch_scene)

# test_own_knot_scene_renders_like_handed_over compares the port's own knot
# build with the JAX package's, which takes the SAH order only with its
# native SAH library loaded.
pytestmark = pytest.mark.usefixtures("jax_native_sah")

ATOL, RTOL = 2e-3, 1e-3
W = H = 16


@pytest.fixture(scope="module")
def jax_cluster_path():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcl, "GROUPS", 1)
        mp.setattr(jcl, "SUPER", jcl.SUB)
        mp.setattr(jintersect, "_use_clusters",
                   lambda scene: scene.has_clusters)
        for name in ("closest_hit", "closest_hit_sorted", "any_hit",
                     "any_hit_sorted"):
            mp.setattr(jcl, name,
                       functools.partial(getattr(jcl, name), interpret=True))
        jax.clear_caches()
        yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def scenes():
    js = jbuiltins.knot_scene(20, 14)
    jcam = jbuiltins.knot_camera(W, H).params()
    return js, torch_scene(js), jcam, torch_cam(jcam)


def _launch(scene, cam, impl, spl=8, depth=2, **kw):
    return engine.render_accumulate(scene, cam, Film.create(H, W, "cpu"), W,
                                    H, samples_per_launch=spl,
                                    max_depth=depth, impl=impl, **kw)


@pytest.mark.parametrize("impl,jimpl", [("auto", "auto"),
                                        ("wavefront", "xla")])
def test_render_accumulate_matches_jax(jax_cluster_path, scenes, impl, jimpl):
    """16², spl 8, depth 2, two launches: "auto" is the sample-major path
    on both sides (gating on), "wavefront" / "xla" the sequential sorted
    path (gating off)."""
    js, ts, jcam, tcam = scenes
    jf = jfilm.Film.create(H, W, track_variance=True)
    tf = Film.create(H, W, "cpu", track_variance=True)
    for _ in range(2):
        jf, jrays = jengine.render_accumulate(
            js, jcam, jf, W, H, samples_per_launch=8, max_depth=2,
            chunk_size=None, impl=jimpl)
        tf, trays = engine.render_accumulate(ts, tcam, tf, W, H,
                                             samples_per_launch=8,
                                             max_depth=2, impl=impl)
        assert trays.dtype == torch.int64
        assert int(trays) == int(float(jrays)) > W * H * 8
    np.testing.assert_allclose(tf.accum.numpy(), np.asarray(jf.accum),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tf.sq.numpy(), np.asarray(jf.sq),
                               atol=ATOL, rtol=RTOL)
    assert int(tf.subframe) == 16 and float(tf.accum.mean()) > 0


@pytest.mark.parametrize("impl,jimpl", [("auto", "auto"),
                                        ("wavefront", "xla")])
def test_supercluster_tier_render_matches_jax(jax_cluster_path, monkeypatch,
                                              impl, jimpl):
    """The supercluster tier forced in both packages (MAX_STREAM_CLUSTERS
    = 2, SC_CLUSTERS = 2: the knot's 5 clusters as 3 superclusters, its table
    built there): one launch, 16², spl 8, depth 2, through the sc walks on
    both sides."""
    for mod in (jcl, tcl):
        monkeypatch.setattr(mod, "MAX_STREAM_CLUSTERS", 2)
        monkeypatch.setattr(mod, "SC_CLUSTERS", 2)
    jax.clear_caches()
    walks = []
    for name in ("walk_sc_closest_plain", "walk_sc_any_plain"):
        fn = getattr(tcl, name)
        monkeypatch.setattr(tcl, name, lambda *a, _fn=fn, _n=name, **k: (
            walks.append(_n), _fn(*a, **k))[1])
    try:
        js = jbuiltins.knot_scene(20, 14)
        assert js.clusters.comp.shape[0] == 6
        ts = torch_scene(js)
        jcam = jbuiltins.knot_camera(W, H).params()
        jf, jrays = jengine.render_accumulate(
            js, jcam, jfilm.Film.create(H, W), W, H, samples_per_launch=8,
            max_depth=2, chunk_size=None, impl=jimpl)
        tf, trays = engine.render_accumulate(
            ts, torch_cam(jcam), Film.create(H, W, "cpu"), W, H,
            samples_per_launch=8, max_depth=2, impl=impl)
    finally:
        jax.clear_caches()
    assert {"walk_sc_closest_plain", "walk_sc_any_plain"} <= set(walks)
    assert int(trays) == int(float(jrays)) > W * H * 8
    np.testing.assert_allclose(tf.accum.numpy(), np.asarray(jf.accum),
                               atol=ATOL, rtol=RTOL)
    assert float(tf.accum.mean()) > 0


def test_trace_paths_sorted_path_matches_jax(jax_cluster_path, scenes):
    """The sequential cluster path on one sample: radiance within the bars
    and the returned rng put back in pixel order, word for word."""
    from optix_raytracer_tpu.core import rng as jrng
    from optix_raytracer_tpu.core.camera import generate_rays as jgen
    from optix_raytracer_tpu_torch.core.camera import generate_rays
    js, ts, jcam, tcam = scenes
    pix = np.arange(W * H, dtype=np.uint32)
    jstate = jrng.seed(jax.numpy.asarray(pix), 3).reshape(H, W)
    jr, jstate = jgen(jcam, W, H, rng_state=jstate)
    jr = jax.tree.map(lambda a: a.reshape((W * H,) + a.shape[2:]), jr)
    jrad, jrng_out, jcount = jengine.trace_paths(
        js, jr, jstate.reshape(-1), max_depth=3)
    tstate = trng.seed(torch.as_tensor(pix.astype(np.int64)), 3)
    tr, tstate = generate_rays(tcam, W, H, rng_state=tstate.reshape(H, W))
    trad, trng_out, tcount = engine.trace_paths(
        ts, tr.reshape(W * H), tstate.reshape(-1), max_depth=3)
    assert int(tcount) == int(float(jcount))
    np.testing.assert_allclose(trad.numpy(), np.asarray(jrad), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_array_equal(trng_out.numpy(),
                                  np.asarray(jrng_out).astype(np.int64))


def test_sample_major_matches_sequential(scenes, monkeypatch):
    """The port's oracle relation on the CPU: the same estimate and counts
    from both paths, for both gating choices (trace_paths' override)."""
    _, ts, _, tcam = scenes
    a, ca = _launch(ts, tcam, "spl", depth=3)
    b, cb = _launch(ts, tcam, "wavefront", depth=3)
    trace = engine.trace_paths
    monkeypatch.setattr(engine, "trace_paths",
                        functools.partial(trace, group_walk=True))
    c, cc = _launch(ts, tcam, "wavefront", depth=3)
    monkeypatch.setattr(engine, "trace_paths",
                        functools.partial(trace, group_walk=False))
    d, cd = _launch(ts, tcam, "spl", depth=3)
    assert int(ca) == int(cb) == int(cc) == int(cd)
    np.testing.assert_allclose(a.accum.numpy(), b.accum.numpy(), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_array_equal(b.accum.numpy(), c.accum.numpy())
    np.testing.assert_array_equal(a.accum.numpy(), d.accum.numpy())


def test_strips_reproduce_one_strip(scenes, monkeypatch):
    """Sample-major strips of 3 rows (the last one padded past the frame)
    give the one-strip launch's image and count."""
    _, ts, _, tcam = scenes
    one, c_one = _launch(ts, tcam, "spl", spl=4)
    monkeypatch.setattr(engine, "_SPL_TILE_RAYS", 3 * W * 4)
    strips, c_strips = _launch(ts, tcam, "spl", spl=4)
    assert int(c_one) == int(c_strips)
    np.testing.assert_allclose(strips.accum.numpy(), one.accum.numpy(),
                               atol=1e-6, rtol=1e-6)


def test_auto_dispatch_on_cluster_scene(scenes):
    """auto: sample-major at spl >= 8, sequential below; never the fused
    kernel on a cluster scene."""
    _, ts, _, tcam = scenes
    assert not engine._use_fused(ts, "auto")
    auto8, c8 = _launch(ts, tcam, "auto")
    spl8, s8 = _launch(ts, tcam, "spl")
    np.testing.assert_array_equal(auto8.accum.numpy(), spl8.accum.numpy())
    auto4, c4 = _launch(ts, tcam, "auto", spl=4)
    wave4, w4 = _launch(ts, tcam, "wavefront", spl=4)
    np.testing.assert_array_equal(auto4.accum.numpy(), wave4.accum.numpy())
    assert int(c8) == int(s8) and int(c4) == int(w4)


def test_own_knot_scene_renders_like_handed_over(scenes):
    """The port's own knot build (its own SAH order, geometry within 1e-6)
    renders the handed-over scene's image within the bars."""
    _, ts, _, tcam = scenes
    own = knot_scene(20, 14, device="cpu")
    a, ca = _launch(own, knot_camera(W, H).params("cpu"), "auto")
    b, cb = _launch(ts, tcam, "auto")
    assert int(ca) == int(cb)
    np.testing.assert_allclose(a.accum.numpy(), b.accum.numpy(), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("impl", ["spl", "wavefront"])
def test_render_accumulate_group_walk(scenes, monkeypatch, impl):
    """render_accumulate(group_walk=...) reaches the cluster queries
    (engine.py:846-852's keyword) and changes only the work: True and False
    give the same image and ray count as the path's default."""
    _, ts, _, tcam = scenes
    seen = []
    query = tcl.closest_hit

    def spy(cl, rays, exact=False, group_walk=False):
        seen.append(group_walk)
        return query(cl, rays, exact=exact, group_walk=group_walk)
    monkeypatch.setattr(tcl, "closest_hit", spy)
    out = {}
    for gw in (None, True, False):
        seen.clear()
        out[gw] = _launch(ts, tcam, impl, spl=8, depth=2, group_walk=gw)
        default = impl == "spl"      # trace_paths: gating on sample-major
        assert set(seen) == {default if gw is None else gw}
    for gw in (True, False):
        assert int(out[gw][1]) == int(out[None][1])
        np.testing.assert_array_equal(out[gw][0].accum.numpy(),
                                      out[None][0].accum.numpy())
