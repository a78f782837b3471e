"""The port's brute-force intersection (plain versions of kernels 1 and 2, on
the CPU) against the JAX Pallas kernels in interpret mode and the XLA matmul
path: hit ids equal, t within rtol 1e-5, uv within 1e-4, normals within 1e-5
(the bars of test_pallas_intersect.py), occlusion equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_raytracer_tpu.accel import bruteforce as jbf
from optix_raytracer_tpu.accel.geometry import build_triangle_geometry as jbuild
from optix_raytracer_tpu.core.rays import Rays as JRays
from optix_raytracer_tpu_torch.accel import bruteforce as tbf
from optix_raytracer_tpu_torch.accel import pallas_bf as tpbf
from optix_raytracer_tpu_torch.accel.geometry import TriangleGeometry
from optix_raytracer_tpu_torch.core.rays import Rays

from test_intersect import random_mesh


@pytest.fixture(scope="module")
def case():
    """40 random triangles, one of them degenerate, and 1500 rays (not a
    multiple of any block size)."""
    rng = np.random.default_rng(7)
    verts, idx = random_mesh(rng, 40)
    idx[17, 2] = idx[17, 1]                 # triangle 17 collapses to a line
    jgeom = jbuild(verts, idx)
    tri_mat = rng.integers(0, 5, 40).astype(np.int32)
    n_rays = 1500
    origins = rng.uniform(-3, 3, (n_rays, 3)).astype(np.float32)
    dirs = rng.normal(size=(n_rays, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    # aim 200 rays straight at the degenerate triangle's first vertex
    tgt = verts[idx[17, 0]]
    aim = tgt[None] - origins[:200]
    dirs[:200] = aim / np.linalg.norm(aim, axis=1, keepdims=True)
    jrays = JRays.make(jnp.asarray(origins), jnp.asarray(dirs),
                       tmin=1e-3, tmax=50.0)
    geom = TriangleGeometry(
        tri_consts=torch.as_tensor(np.array(jgeom.tri_consts)),
        face_normal=torch.as_tensor(np.array(jgeom.face_normal)),
        valid=torch.as_tensor(np.array(jgeom.valid)))
    rays = Rays.make(torch.as_tensor(origins), torch.as_tensor(dirs),
                     tmin=1e-3, tmax=50.0)
    return jgeom, jrays, jnp.asarray(tri_mat), geom, rays, \
        torch.as_tensor(tri_mat)


def _assert_hits_match(out, ref):
    np.testing.assert_array_equal(out.prim_id.numpy(), np.asarray(ref.prim_id))
    np.testing.assert_array_equal(out.mat_id.numpy(), np.asarray(ref.mat_id))
    hit = np.asarray(ref.valid)
    assert hit.sum() > 100 and (~hit).sum() > 100
    np.testing.assert_allclose(out.t.numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=1e-5)
    np.testing.assert_allclose(out.uv.numpy()[hit], np.asarray(ref.uv)[hit],
                               atol=1e-4)
    np.testing.assert_allclose(out.normal.numpy()[hit],
                               np.asarray(ref.normal)[hit], atol=1e-5)


@pytest.mark.parametrize("ref_impl", ["pallas_interpret", "xla"])
def test_closest_matches_jax(case, ref_impl):
    jgeom, jrays, jmat, geom, rays, tmat = case
    ref = jbf.intersect_closest(jgeom, jrays, tri_mat=jmat, impl=ref_impl,
                                chunk_size=None)
    out = tbf.intersect_closest(geom, rays, tri_mat=tmat, chunk_size=256)
    _assert_hits_match(out, ref)
    assert not (out.prim_id.numpy() == 17).any()   # degenerate never hit


@pytest.mark.parametrize("ref_impl", ["pallas_interpret", "xla"])
def test_any_matches_jax(case, ref_impl):
    jgeom, jrays, _, geom, rays, _ = case
    ref = jbf.intersect_any(jgeom, jrays, impl=ref_impl, chunk_size=None)
    out = tbf.intersect_any(geom, rays, chunk_size=256)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_miss_semantics(case):
    *_, geom, rays, tmat = case
    out = tpbf.closest_hit(geom.tri_consts, tmat, rays)
    miss = out["prim_id"].numpy() < 0
    assert miss.any()
    np.testing.assert_array_equal(out["mat_id"].numpy()[miss], -1)
    np.testing.assert_array_equal(out["t"].numpy()[miss],
                                  rays.tmax.numpy()[miss])
    np.testing.assert_array_equal(out["uv"].numpy()[miss], 0.0)
    np.testing.assert_array_equal(out["normal"].numpy()[miss], 0.0)


def test_batch_shape_and_chunking(case):
    """[30, 50] ray batches come back in their shape; the chunk size does
    not change a single value."""
    *_, geom, rays, tmat = case
    whole = tbf.intersect_closest(geom, rays, tri_mat=tmat, chunk_size=None)
    grid = tbf.intersect_closest(geom, rays.reshape(30, 50), tri_mat=tmat,
                                 chunk_size=97)
    assert grid.t.shape == (30, 50) and grid.normal.shape == (30, 50, 3)
    np.testing.assert_array_equal(grid.t.reshape(-1).numpy(), whole.t.numpy())
    np.testing.assert_array_equal(grid.prim_id.reshape(-1).numpy(),
                                  whole.prim_id.numpy())
    occ = tbf.intersect_any(geom, rays.reshape(30, 50), chunk_size=7)
    np.testing.assert_array_equal(
        occ.reshape(-1).numpy(),
        tbf.intersect_any(geom, rays, chunk_size=None).numpy())


def test_window_is_exclusive():
    """A hit exactly at tmax or tmin is not a hit (strict comparisons)."""
    verts = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    from optix_raytracer_tpu_torch.accel.geometry import build_triangle_geometry
    g = build_triangle_geometry(verts, np.array([[0, 1, 2]], np.int32), "cpu")
    o = torch.tensor([[0.0, 0.0, 2.0]] * 3)
    d = torch.tensor([[0.0, 0.0, -1.0]] * 3)
    rays = Rays(origin=o, direction=d, tmin=torch.tensor([0.0, 2.0, 0.0]),
                tmax=torch.tensor([2.0, 5.0, 2.5]))
    np.testing.assert_array_equal(tbf.intersect_any(g, rays).numpy(),
                                  [False, False, True])
