"""The port's fog volumes (core/aabb.py, accel/volume.py, the engine's volume
lanes, io/nanovdb.py, the volume viewer app) against the JAX package on
the CPU, on the same numpy inputs made from a seed.

Bars: the slab test's masks equal and t within 1e-6; sample_grid within
1e-6 (the same ops, eager on both sides); optical_depth, sample_scatter,
segment_scatter_nee and march within 1e-5 relative / 1e-6 absolute (the
reference's loops run compiled, where XLA:CPU contracts FMAs); the
puffball and the NanoVDB round trips bit-equal; renders with equal ray
counts and radiance within atol 2e-3 / rtol 1e-3, the pixels outside the
bar counted and required to be none. About 60 s on one worker, most of it
the JAX compiles of render_accumulate and march.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_raytracer_tpu.accel import volume as jvol
from optix_raytracer_tpu.apps import volume_viewer as jvv
from optix_raytracer_tpu.core import aabb as jaabb
from optix_raytracer_tpu.core import film as jfilm
from optix_raytracer_tpu.core.rays import Rays as JRays
from optix_raytracer_tpu.io import nanovdb as jnv
from optix_raytracer_tpu.scene import builtins as jb
from optix_raytracer_tpu.scene.device_scene import (
    make_device_scene as jmake_device_scene)
from optix_raytracer_tpu.shade.lights import ParallelogramLight as JLight
from optix_raytracer_tpu.wavefront import engine as jengine
from optix_raytracer_tpu_torch.accel import volume as vol
from optix_raytracer_tpu_torch.apps import volume_viewer as vv
from optix_raytracer_tpu_torch.core import aabb
from optix_raytracer_tpu_torch.core.film import Film
from optix_raytracer_tpu_torch.core.rays import Rays
from optix_raytracer_tpu_torch.io import nanovdb as nv
from optix_raytracer_tpu_torch.scene import builtins as B
from optix_raytracer_tpu_torch.shade.lights import ParallelogramLight
from optix_raytracer_tpu_torch.wavefront import engine

from torch_parity import (assert_image_close, one_torch_thread,  # noqa: F401
                          torch_cam, torch_scene)

LOOP_RTOL, LOOP_ATOL = 1e-5, 1e-6


def _grids(shape, seed, lo=(-1.0, -0.5, -0.8), hi=(1.2, 0.7, 0.9)):
    """A random density grid [D, H, W] in a box, as both packages'
    DensityGrid."""
    dens = np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)
    j = jvol.DensityGrid(density=jnp.asarray(dens), lo=jnp.asarray(lo),
                         hi=jnp.asarray(hi))
    return j, vol.DensityGrid.from_numpy(dens, lo, hi, "cpu")


def _segments(seed, n=500):
    """Rays through the box region: origins around it, directions at it,
    windows [0.05, 3-6]; every fourth direction has a zero component."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    d = (rng.uniform(-0.6, 0.6, (n, 3)) - o).astype(np.float32)
    d[::4, 1] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t0 = np.full(n, 0.05, np.float32)
    t1 = rng.uniform(3.0, 6.0, n).astype(np.float32)
    return o, d, t0, t1


def test_aabb_intersect_ray_matches_jax():
    rng = np.random.default_rng(1)
    lo = np.array([-1.0, -0.5, 0.2], np.float32)
    hi = np.array([0.7, 1.5, 0.9], np.float32)
    o, d, t0, t1 = _segments(1, n=600)
    d[5::7] = [0.0, 0.0, 1.0]                 # axis-aligned: inf inv_dir
    o[5::7, :2] = rng.uniform(-1.2, 1.8, (len(o[5::7]), 2))
    with np.errstate(divide="ignore"):
        inv = (1.0 / d).astype(np.float32)
    hit, te = aabb.intersect_ray(torch.as_tensor(lo), torch.as_tensor(hi),
                                 torch.as_tensor(o), torch.as_tensor(inv),
                                 torch.as_tensor(t0), torch.as_tensor(t1))
    jhit, jte = jaabb.intersect_ray(lo, hi, o, inv, t0, t1)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    h = hit.numpy()
    assert h.any() and (~h).any()
    np.testing.assert_allclose(te.numpy()[h], np.asarray(jte)[h], rtol=1e-6)
    pts = torch.as_tensor(rng.normal(size=(5, 4, 3)).astype(np.float32))
    box = aabb.from_points(pts)
    jbox = jaabb.from_points(jnp.asarray(pts.numpy()))
    for a, b in zip(box + aabb.union(box, aabb.empty((5,))),
                    jbox + jaabb.union(jbox, jaabb.empty((5,)))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(aabb.surface_area(box).numpy(),
                               np.asarray(jaabb.surface_area(jbox)),
                               rtol=1e-6)
    np.testing.assert_array_equal(aabb.center(box).numpy(),
                                  np.asarray(jaabb.center(jbox)))
    np.testing.assert_array_equal(aabb.extent(box).numpy(),
                                  np.asarray(jaabb.extent(jbox)))


@pytest.mark.parametrize("shape", [(8, 8, 8), (5, 9, 13), (1, 4, 5)],
                         ids=["cubic", "non_cubic", "one_voxel_axis"])
def test_sample_grid_matches_jax(shape):
    """Points inside, outside, on the box's faces and corners, on voxel
    centres (where the clip to res - 1.001 acts on the last one), and NaN
    points (0: XLA's gather clamps their indices, the port clamps them)."""
    jg, tg = _grids(shape, seed=2)
    rng = np.random.default_rng(3)
    lo, hi = np.asarray(jg.lo), np.asarray(jg.hi)
    pts = [rng.uniform(lo - 0.2, hi + 0.2, (400, 3))]
    corners = np.array(np.meshgrid(*zip(lo, hi), indexing="ij")).reshape(3, -1)
    pts.append(corners.T)
    face = rng.uniform(lo, hi, (60, 3))
    face[:20, 0], face[20:40, 1], face[40:, 2] = hi[0], lo[1], hi[2]
    pts.append(face)
    res = np.array(shape[::-1])
    cells = rng.integers(0, res, (60, 3))
    pts.append(lo + cells / (res - 1) * (hi - lo))
    pts.append(np.full((4, 3), np.nan))
    pts = np.concatenate(pts).astype(np.float32)
    out = vol.sample_grid(tg, torch.as_tensor(pts)).numpy()
    ref = np.asarray(jvol.sample_grid(jg, jnp.asarray(pts)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    assert (out == 0).any() and (out > 0).sum() > 150


def test_volume_marches_match_jax():
    """optical_depth, sample_scatter (u spread over [0, 1], and 1 itself),
    segment_scatter_nee and march (with and without a background) on a
    non-cubic grid; the puffball bit-equal."""
    jg, tg = _grids((6, 10, 7), seed=4)
    o, d, t0, t1 = _segments(5)
    n = len(o)
    u = np.linspace(0.0, 1.0, n).astype(np.float32)
    T = lambda a: torch.as_tensor(a)  # noqa: E731
    J = jnp.asarray
    for steps in (16, 5):
        out = vol.optical_depth(tg, T(o), T(d), T(t0), T(t1), 0.7,
                                num_steps=steps)
        ref = jvol.optical_depth(jg, J(o), J(d), J(t0), J(t1), 0.7,
                                 num_steps=steps)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   rtol=LOOP_RTOL, atol=LOOP_ATOL)
    assert (out.numpy() > 0).sum() > n // 4 and (out.numpy() == 0).any()
    outs = vol.sample_scatter(tg, T(o), T(d), T(t0), T(t1), 0.9, T(u))
    refs = jvol.sample_scatter(jg, J(o), J(d), J(t0), J(t1), 0.9, J(u))
    for name, a, b in zip(("t_s", "w", "tau"), outs, refs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=LOOP_RTOL,
                                   atol=LOOP_ATOL, err_msg=name)
    light = ParallelogramLight.make((-0.3, 2.0, -0.3), (0.6, 0, 0),
                                    (0, 0, 0.6), (8.0, 7.0, 6.0), "cpu")
    jlight = JLight.make((-0.3, 2.0, -0.3), (0.6, 0, 0), (0, 0, 0.6),
                         (8.0, 7.0, 6.0))
    tau, rad = vol.segment_scatter_nee(tg, T(o), T(d), T(t0), T(t1), 0.8,
                                       0.9, light)
    jtau, jrad = jvol.segment_scatter_nee(jg, J(o), J(d), J(t0), J(t1), 0.8,
                                          0.9, jlight)
    np.testing.assert_allclose(tau.numpy(), np.asarray(jtau),
                               rtol=LOOP_RTOL, atol=LOOP_ATOL)
    np.testing.assert_allclose(rad.numpy(), np.asarray(jrad),
                               rtol=LOOP_RTOL, atol=LOOP_ATOL)
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, 1e16, np.float32)
    rays = Rays(T(o), T(d), T(tmin), T(tmax))
    jrays = JRays(J(o), J(d), J(tmin), J(tmax))
    bg = np.random.default_rng(6).uniform(0, 1, (n, 3)).astype(np.float32)
    bg_t = np.where(np.arange(n) % 3 == 0, 2.5, 1e16).astype(np.float32)
    for ld, extra in (((-0.5, -0.8, -0.33), {}),
                      ((0.9, 0.2, 0.1), dict(bg_radiance=bg, bg_t=bg_t))):
        out = vol.march(tg, rays, ld, (1.0, 0.95, 0.85), sigma_t=3.0,
                        num_steps=24, **{k: T(v) for k, v in extra.items()})
        ref = jvol.march(jg, jrays, ld, J((1.0, 0.95, 0.85)), sigma_t=3.0,
                         num_steps=24, **{k: J(v) for k, v in extra.items()})
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=LOOP_RTOL, atol=LOOP_ATOL)
    for res, seed in ((16, 0), (24, 5)):
        ball = vol.pyroclastic_ball(res, seed, device="cpu")
        jball = jvol.pyroclastic_ball(res, seed)
        for f in ("density", "lo", "hi"):
            np.testing.assert_array_equal(getattr(ball, f).numpy(),
                                          np.asarray(getattr(jball, f)))


def _sparse_grid(seed=0, shape=(40, 24, 56)):
    """tests/test_nanovdb.py's sparse grid: a random blob over many leaves,
    voxels under 0.3 inactive."""
    rng = np.random.default_rng(seed)
    vals = np.zeros(shape, np.float32)
    vals[10:26, 8:16, 20:44] = rng.uniform(0.2, 1.0, (16, 8, 24))
    vals[vals < 0.3] = 0.0
    return vals


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("codec", ["none", "zip"])
def test_nanovdb_codec_both_ways(tmp_path, writer, codec):
    """The port's writer read by the JAX package's reader and the JAX
    writer read by the port's: the same bytes, values, metadata and world
    box, on a multi-leaf lattice at a non-zero origin, raw and ZIP; and
    load_density_grid equal (with and without the mean-pool)."""
    vals = _sparse_grid(seed=3 if codec == "zip" else 0)
    kw = dict(ijk_min=(8, -16, 0), voxel_size=(0.5, 0.25, 1.0),
              translation=(1.0, 2.0, 3.0), name="dens",
              codec=nv.CODEC_ZIP if codec == "zip" else nv.CODEC_NONE)
    a, b = str(tmp_path / "a.nvdb"), str(tmp_path / "b.nvdb")
    (nv if writer == "port" else jnv).write_nvdb(a, vals, **kw)
    (jnv if writer == "port" else nv).write_nvdb(b, vals, **kw)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    g, jg = nv.read_nvdb(a), jnv.read_nvdb(a)
    assert g.values.shape[0] > 8 and g.name == jg.name == "dens"
    for f in ("values", "ijk_min", "voxel_size", "translation", "world_lo",
              "world_hi"):
        np.testing.assert_array_equal(getattr(g, f), getattr(jg, f),
                                      err_msg=f)
    off = g.ijk_min - np.array([8, -16, 0])
    np.testing.assert_array_equal(
        g.values, vals[off[2]:off[2] + g.values.shape[0],
                       off[1]:off[1] + g.values.shape[1],
                       off[0]:off[0] + g.values.shape[2]])
    assert [m.name for m in nv.read_grid_metadata(a)] == ["dens"]
    for max_voxels in (192 ** 3, 500):
        dg = nv.load_density_grid(a, max_voxels=max_voxels, device="cpu")
        jdg = jnv.load_density_grid(a, max_voxels=max_voxels)
        for f in ("density", "lo", "hi"):
            np.testing.assert_array_equal(getattr(dg, f).numpy(),
                                          np.asarray(getattr(jdg, f)),
                                          err_msg=f)


def test_nanovdb_level_set_and_names(tmp_path):
    """A level-set grid loads as the inside's unit density in both
    packages; a missing grid name raises."""
    sdf = np.linspace(-1, 1, 16 * 16 * 16).reshape(16, 16, 16).astype(
        np.float32)
    p = str(tmp_path / "ls.nvdb")
    nv.write_nvdb(p, sdf, grid_class=nv.GRID_CLASS_LEVEL_SET, name="ls",
                  background=3.0)
    dg, jdg = nv.load_density_grid(p, device="cpu"), jnv.load_density_grid(p)
    np.testing.assert_array_equal(dg.density.numpy(), np.asarray(jdg.density))
    assert set(np.unique(dg.density.numpy())) == {0.0, 1.0}
    with pytest.raises(ValueError, match="no grid named"):
        nv.read_nvdb(p, "other")


def _jax_cloud_scene(res=16):
    """The JAX twin of volume_viewer.engine_scene (the reference's
    render_engine scene)."""
    verts, idx, tri_mat = jb.quads_to_triangles(jb._CORNELL_QUADS)
    ball = jvol.pyroclastic_ball(res=res)
    span = ball.hi - ball.lo
    lo = jnp.asarray([140.0, 80.0, 150.0])
    cloud = jvol.DensityGrid(density=ball.density, lo=lo,
                             hi=lo + span * (280.0 / jnp.max(span)))
    light = JLight.make(jb.CORNELL_LIGHT_CORNER, jb.CORNELL_LIGHT_V1,
                        jb.CORNELL_LIGHT_V2, jb.CORNELL_LIGHT_EMISSION)
    return jmake_device_scene(verts, idx, tri_mat, jb.CORNELL_MATERIALS,
                              area_light=light, volume=cloud,
                              volume_sigma=0.02, volume_albedo=0.95)


@pytest.mark.parametrize("handed_over", [True, False])
def test_volume_engine_matches_jax(handed_over):
    """render_accumulate on the Cornell cloud (16x16, 4 samples, depth 2):
    equal ray counts (the scatter shadow rays not counted) and radiance
    within the bar; the JAX scene handed over, and the port's own build."""
    jscene = _jax_cloud_scene()
    scene = (torch_scene(jscene) if handed_over
             else vv.engine_scene("cpu", res=16))
    assert scene.has_volume and scene.features == ("volume",)
    np.testing.assert_array_equal(scene.volume.hi.numpy(),
                                  np.asarray(jscene.volume.hi))
    jcam = jb.cornell_camera(16, 16).params()
    jf, jrays = jengine.render_accumulate(
        jscene, jcam, jfilm.Film.create(16, 16), 16, 16,
        samples_per_launch=4, max_depth=2, chunk_size=None)
    tf, trays = engine.render_accumulate(
        scene, torch_cam(jcam), Film.create(16, 16, "cpu"), 16, 16,
        samples_per_launch=4, max_depth=2, chunk_size=None)
    assert int(trays) == int(jrays)
    assert_image_close(tf.accum.numpy(), np.asarray(jf.accum), "Cornell cloud")
    assert not engine._use_fused(scene, "auto")


def test_volume_viewer_app_matches_jax(tmp_path):
    """Both modes at 16x16: the standalone march (the puffball at res 24, 32
    steps; and a .nvdb grid written here through --grid's path), and
    --engine (res 16, depth 2), through the apps' own builds."""
    out, _ = vv.render(16, 16, samples=2, res=24, num_steps=32, device="cpu")
    ref, _ = jvv.render(16, 16, samples=2, res=24, num_steps=32)
    assert_image_close(out.numpy(), ref, "volume_viewer")
    path = str(tmp_path / "g.nvdb")
    nv.write_nvdb(path, _sparse_grid(1), ijk_min=(8, 0, -8),
                  voxel_size=0.05, name="density")
    out, _ = vv.render(16, 16, samples=1, num_steps=32, grid_file=path,
                       device="cpu")
    ref, _ = jvv.render(16, 16, samples=1, num_steps=32, grid_file=path)
    assert_image_close(out.numpy(), ref, "volume_viewer --grid")
    out, film, rays = vv.render_engine(16, 16, 4, res=16, max_depth=2,
                                       device="cpu")
    ref, _ = jvv.render_engine(16, 16, 4, res=16, max_depth=2)
    assert_image_close(out.numpy(), ref, "volume_viewer --engine")
    assert int(rays) > 16 * 16 * 4 and float(out.max()) > 0
    img = tmp_path / "v.ppm"
    vv.main(["--file", str(img), "--dim", "8x8", "--samples", "1",
             "--res", "16", "--steps", "8", "--grid", path, "--device",
             "cpu"])
    assert img.stat().st_size == len(b"P6\n8 8\n255\n") + 8 * 8 * 3
