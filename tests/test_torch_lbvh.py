"""The port's LBVH build and threaded-BVH walk (`accel/lbvh.py`,
`accel/traverse.py`) and the scene's BVH dispatch against the JAX package
on the CPU.

Bars: the node arrays equal the JAX build's (node_skip / node_prim equal,
node_lo / node_hi bit-equal), for n in {2, 3, 600, 5000}, adversarial and
duplicate codes and after `refit_gas`; the walk's prim ids, material ids
and occlusion equal on every ray; t and uv within atol 1e-6 + rtol 1e-6
plus UV_ULPS float32 ulps of the Woop offsets' magnitude |op| = |c0 o_x| +
|c1 o_y| + |c2 o_z| + |c9| (for t, op_z's divided by |dp_z|): on a sliver
triangle t = -op_z / dp_z and u = op_x + t dp_x cancel large terms, and the
reference's einsum (XLA:CPU's dot, eager or under jit) rounds op apart from
the port's written-out sums (the walk kernel's), so t and u move by a few
ulps of |op|, not of themselves (at most 14 seen, on 1-2 rays in 619
hits). The JAX build
runs eagerly (`jax.disable_jit()`: the same integer and min / max
arithmetic as under jit, without a ~15 s compile per size), on v0 / e1 / e2
made in numpy as the JAX geometry makes them (`jax_lbvh`); the JAX walk
runs jitted, as its own tests run it (on 600 random triangles, two small
meshes and the 2,402-triangle knot).

The dispatch runs with the caps lowered (`clusters.MAX_SUPERCLUSTERS`,
`SC_CLUSTERS`, read at call time), so a 2,402-triangle knot is past the
cluster tier: with a BVH it walks it, without one it takes brute force,
both with the JAX scene's hits (the JAX scene walks its LBVH on the CPU).
About 46 s on one worker with a cold JAX cache.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_raytracer_tpu import api as japi
from optix_raytracer_tpu.accel import lbvh as jlbvh
from optix_raytracer_tpu.accel.geometry import (
    build_triangle_geometry as jbuild)
from optix_raytracer_tpu.accel.traverse import traverse as jtraverse
from optix_raytracer_tpu.core.rays import Rays as JRays
from optix_raytracer_tpu_torch import api
from optix_raytracer_tpu_torch.accel import clusters as C
from optix_raytracer_tpu_torch.accel import lbvh, native
from optix_raytracer_tpu_torch.accel import traverse as trav
from optix_raytracer_tpu_torch.accel.geometry import build_triangle_geometry
from optix_raytracer_tpu_torch.core.rays import Rays
from optix_raytracer_tpu_torch.scene import builtins as B
from optix_raytracer_tpu_torch.scene.device_scene import make_device_scene
from optix_raytracer_tpu_torch.wavefront import intersect

from torch_parity import one_torch_thread  # noqa: F401

UV_ULPS = 32
NODE_FIELDS = ("node_lo", "node_hi", "node_skip", "node_prim")


def jax_bvh(tb):
    """The port's LBVH as the JAX package's (its build is held equal to
    the JAX build above), for the JAX walk."""
    return jlbvh.LBVH(**{f: jnp.asarray(getattr(tb, f).numpy())
                         for f in NODE_FIELDS})


def jax_lbvh(verts, idx):
    """The JAX package's LBVH of a mesh, built eagerly. The build reads
    only v0, e1 and e2 of its geometry, so these come from numpy as
    `build_triangle_geometry` makes them (gathers and f32 differences),
    sparing each size a compile of the JAX table builder."""
    v = verts[idx]
    geom = types.SimpleNamespace(v0=jnp.asarray(v[:, 0]),
                                 e1=jnp.asarray(v[:, 1] - v[:, 0]),
                                 e2=jnp.asarray(v[:, 2] - v[:, 0]),
                                 num_triangles=len(idx))
    with jax.disable_jit():
        return jlbvh.build_lbvh(geom)


def random_mesh(n, seed):
    """tests/test_intersect.py::random_mesh's triangles (edges in
    [-1, 1]^3: slivers included), one degenerate from 9 on."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    if n >= 9:
        e2[n // 2] = e1[n // 2]
    verts = np.concatenate([v0, v0 + e1, v0 + e2]).astype(np.float32)
    idx = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n],
                   axis=1).astype(np.int32)
    return verts, idx


def random_rays(n, seed, tmax=100.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d, np.full(n, 1e-3, np.float32), np.full(n, tmax, np.float32)


def both_rays(o, d, tmin, tmax):
    return (JRays(origin=jnp.asarray(o), direction=jnp.asarray(d),
                  tmin=jnp.asarray(tmin), tmax=jnp.asarray(tmax)),
            Rays(origin=torch.as_tensor(o), direction=torch.as_tensor(d),
                 tmin=torch.as_tensor(tmin), tmax=torch.as_tensor(tmax)))


def bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_bvh_equal(tb, jb, what):
    for f in NODE_FIELDS:
        a, b = getattr(tb, f).numpy(), np.asarray(getattr(jb, f))
        assert a.shape == b.shape, (what, f)
        assert np.array_equal(bits(a), bits(b)), (what, f)


def assert_walk_close(th, jh, geom, o, d, what):
    """Ids equal; t and uv within 1e-6 plus UV_ULPS ulps of the Woop
    offsets' magnitude (for t divided by |dp_z|; module docstring)."""
    for f in ("prim_id", "mat_id", "inst_id"):
        assert np.array_equal(getattr(th, f).numpy(),
                              np.asarray(getattr(jh, f))), (what, f)
    np.testing.assert_allclose(th.normal.numpy(), np.asarray(jh.normal),
                               rtol=1e-6, atol=1e-6, err_msg=what)
    c = geom.tri_consts.numpy()[np.maximum(th.prim_id.numpy(), 0)]
    scale = np.stack([np.abs(c[:, 3 * k:3 * k + 3] * o).sum(1)
                      + np.abs(c[:, 9 + k]) for k in range(3)], axis=1)
    dpz = np.abs((c[:, 6:9] * d).sum(1))
    ulps = UV_ULPS * np.finfo(np.float32).eps
    tt, jt = th.t.numpy(), np.asarray(jh.t)
    bar_t = 1e-6 + 1e-6 * np.abs(jt) + ulps * scale[:, 2] / np.maximum(
        dpz, 1e-12) * th.valid.numpy()
    assert (np.abs(tt - jt) <= bar_t).all(), (what, np.abs(tt - jt).max())
    tu, ju = th.uv.numpy(), np.asarray(jh.uv)
    bar = 1e-6 + 1e-6 * np.abs(ju) + ulps * scale[:, :2]
    assert (np.abs(tu - ju) <= bar).all(), (what, np.abs(tu - ju).max())


@pytest.mark.parametrize("n", [2, 3, 600, 5000])
def test_lbvh_equals_jax(n):
    """A random mesh's LBVH: the node arrays equal the JAX build's."""
    verts, idx = random_mesh(n, n)
    geom = build_triangle_geometry(verts, idx, "cpu")
    jb = jax_lbvh(verts, idx)
    tb = lbvh.build_lbvh(geom)
    assert tb.num_nodes == 2 * n - 1
    assert_bvh_equal(tb, jb, f"n={n}")
    prim = tb.node_prim.numpy()
    assert np.array_equal(np.sort(prim[prim >= 0]), np.arange(n))


def test_lbvh_duplicate_and_degenerate_geometry():
    """Equal codes (600 identical triangles; a 600-triangle mesh whose
    second half repeats its first) and one triangle, the index tie-break:
    equal to the JAX build."""
    tri = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    verts, idx = random_mesh(300, 7)
    cases = {"identical": (np.tile(tri, (600, 1)),
                           np.arange(1800, dtype=np.int32).reshape(600, 3)),
             "repeated half": (np.concatenate([verts, verts]),
                               np.concatenate([idx, idx + len(verts)])),
             "one triangle": (tri, np.array([[0, 1, 2]], np.int32))}
    for what, (v, i) in cases.items():
        jb = jax_lbvh(v, i)
        assert_bvh_equal(lbvh.build_lbvh(build_triangle_geometry(v, i,
                                                                 "cpu")),
                         jb, what)


@pytest.mark.parametrize("case", ["seed0", "seed1", "skewed"])
def test_topology_adversarial_codes(case):
    """Sorted codes clustered just below powers of two (test_lbvh.py:
    70-83, seeds 0 and 1) and the maximally skewed 0, 1, 3, ... 2^30 - 1:
    the children equal the JAX topology's (run eagerly)."""
    if case == "skewed":
        c = np.array([(1 << k) - 1 for k in range(31)], np.uint32)
    else:
        rng = np.random.default_rng(int(case[-1]))
        n = 257
        base = np.array([(1 << 24) - 1, (1 << 25) - 1, (1 << 27) - 1,
                         (1 << 29) - 1, (1 << 30) - 1], np.int64)
        codes = base[rng.integers(0, len(base), n)] \
            - rng.integers(0, 3, n) + rng.integers(0, 2, n)
        c = np.sort(codes.astype(np.uint32))
    with jax.disable_jit():
        jl, jr = jlbvh._build_topology(jnp.asarray(c), len(c))
    tl, tr = lbvh._build_topology(torch.as_tensor(c.astype(np.int64)),
                                  len(c))
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    assert np.array_equal(tr.numpy(), np.asarray(jr))


def test_log2_floor_exact():
    """The integer floor(log2) around every power of two up to 2^32 - 1 and
    at 0, equal to the JAX clz form (test_lbvh.py:55-68)."""
    vals = [0]
    for k in range(1, 32):
        vals += [(1 << k) - 1, 1 << k, (1 << k) + 1]
    vals = np.array([v for v in vals if v < 1 << 32], np.uint32)
    got = lbvh._log2_floor(torch.as_tensor(vals.astype(np.int64))).numpy()
    want = np.asarray(jlbvh._log2_floor(jnp.asarray(vals)))
    assert np.array_equal(got, want)
    assert got[0] == -1 and got[1] == 0


def test_refit_rebuilds_equal_lbvh():
    """build_gas past 512 triangles builds the LBVH, refit_gas rebuilds it
    over moved vertices: both equal the JAX api's."""
    verts, idx = random_mesh(600, 11)
    moved = verts + np.sin(3.0 * verts[:, ::-1]).astype(np.float32) * 0.2
    h = api.build_gas(verts, idx, device="cpu")
    with jax.disable_jit():
        jh = japi.build_gas(verts, idx)
        jh2 = japi.refit_gas(jh, jnp.asarray(moved))
    assert h.bvh is not None and jh.bvh is not None
    assert_bvh_equal(h.bvh, jh.bvh, "build_gas")
    h2 = api.refit_gas(h, moved)
    assert_bvh_equal(h2.bvh, jh2.bvh, "refit_gas")
    assert np.array_equal(bits(h2.geom.v0.numpy()), bits(jh2.geom.v0))


@pytest.mark.parametrize("n", [600])
def test_walk_equals_jax(n):
    """Closest hit and occlusion through the same LBVH: the JAX walk's ids
    and occlusion on every ray, t and uv within the bars; random rays with
    a material table, and with tmax 0.3 (every hit within it)."""
    verts, idx = random_mesh(n, n + 1)
    geom = build_triangle_geometry(verts, idx, "cpu")
    jgeom = jbuild(verts, idx)      # jitted, as the JAX tests build it
    tb = lbvh.build_lbvh(geom)
    jb = jax_bvh(tb)
    tri_mat = np.random.default_rng(n).integers(0, 5, n).astype(np.int32)
    for tmax in (100.0, 0.3):
        o, d, tmin, tm = random_rays(1500, n + 2, tmax)
        jr, tr = both_rays(o, d, tmin, tm)
        th = trav.traverse(tb, geom, torch.as_tensor(tri_mat), tr)
        jh = jtraverse(jb, jgeom, jnp.asarray(tri_mat), jr)
        assert_walk_close(th, jh, geom, o, d, f"n={n} tmax={tmax}")
        assert (th.t.numpy()[th.valid.numpy()] <= tmax).all()
        occ = trav.traverse(tb, geom, None, tr, any_hit=True)
        jocc = jtraverse(jb, jgeom, None, jr, any_hit=True)
        assert np.array_equal(occ.numpy(), np.asarray(jocc))
        assert int(th.valid.sum()) > 20


def test_walk_plain_counts():
    """The lock-step loop's counters (the walk kernel's bound on the card):
    the same hits as without them; every ray visits the root; the rows
    any ray touched hold every winner and no more than the visits and
    leaf tests made; the packed table's views are the node arrays."""
    verts, idx = random_mesh(600, 5)
    geom = build_triangle_geometry(verts, idx, "cpu")
    tb = lbvh.build_lbvh(geom)
    _, tr = both_rays(*random_rays(800, 6))
    plain = trav.walk_plain(tb, geom.tri_consts, tr)
    *out, visits, tests, node_seen, tri_seen = trav.walk_plain(
        tb, geom.tri_consts, tr, counts=True)
    assert all(torch.equal(a, b) for a, b in zip(out, plain))
    assert node_seen.shape == (tb.num_nodes,) and tri_seen.shape == (600,)
    assert bool((visits >= 1).all()) and bool(node_seen[0])
    prim = out[1]
    assert bool(tri_seen[prim[prim >= 0].long()].all())
    assert 0 < int(tri_seen.sum()) <= int(tests.sum())
    assert int(node_seen.sum()) <= int(visits.sum())
    assert tb.nodes.shape == (tb.num_nodes, 8)
    assert torch.equal(tb.node_skip, tb.nodes[:, 3].view(torch.int32))


def test_walk_box_faces_and_flat_grid():
    """An axis-aligned ray with its origin on a node bound and zero
    direction components (test_lbvh.py:147-161: the clamped reciprocal
    keeps it), and a flat 12x12 quad grid (one morton axis degenerate):
    equal to the JAX walk, which hits where brute force does."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0],
                      [0, 0, 2], [1, 0, 2], [0, 1, 2]], np.float32)
    idx = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    o = np.array([[0.25, 0.25, 5.0], [0.0, 0.25, 5.0]], np.float32)
    d = np.array([[0, 0, -1], [0, 0, -1]], np.float32)
    cases = [(verts, idx, o, d)]
    m = 12
    xs, ys = np.meshgrid(np.arange(m + 1, dtype=np.float32),
                         np.arange(m + 1, dtype=np.float32))
    gv = np.stack([xs, ys, np.zeros_like(xs)], -1).reshape(-1, 3)
    quads = []
    for y in range(m):
        for x in range(m):
            a = y * (m + 1) + x
            quads += [[a, a + 1, a + m + 2], [a, a + m + 2, a + m + 1]]
    rng = np.random.default_rng(7)
    go = rng.uniform(0, m, (200, 3)).astype(np.float32)
    go[:, 2] = rng.uniform(1, 3, 200)
    gd = rng.normal(size=(200, 3)).astype(np.float32)
    gd /= np.linalg.norm(gd, axis=1, keepdims=True)
    cases.append((gv, np.array(quads, np.int32), go, gd))
    for v, i, ro, rd in cases:
        geom = build_triangle_geometry(v, i, "cpu")
        with jax.disable_jit():
            jgeom = jbuild(v, i)
        tb = lbvh.build_lbvh(geom)
        jb = jax_bvh(tb)
        n = len(ro)
        jr, tr = both_rays(ro, rd, np.full(n, 1e-3, np.float32),
                           np.full(n, 100.0, np.float32))
        th = trav.traverse(tb, geom, None, tr)
        assert_walk_close(th, jtraverse(jb, jgeom, None, jr), geom, ro, rd,
                          f"{len(i)} triangles")
        bf = intersect.bf.intersect_closest(geom, tr)
        assert np.array_equal(th.prim_id.numpy(), bf.prim_id.numpy())
    assert th.valid.any()


def _knot_scene(monkeypatch, with_bvh):
    """The 2,402-triangle knot with the cluster tier's cap lowered to 2
    clusters → (the port's scene, its JAX geometry and material ids)."""
    monkeypatch.setattr(C, "MAX_SUPERCLUSTERS", 1)
    monkeypatch.setattr(C, "SC_CLUSTERS", 2)
    verts, idx, normals, tri_mat, light = B.knot_mesh(40, 30)
    scene = make_device_scene(verts, idx, tri_mat, B.KNOT_MATERIALS, "cpu",
                              with_bvh=with_bvh)
    return scene, jbuild(verts, idx), jnp.asarray(tri_mat)


@pytest.mark.parametrize("with_bvh", [True, False])
def test_dispatch_past_the_cluster_cap(monkeypatch, with_bvh):
    """Past the cap the port's scene has no cluster table; with a BVH (the
    native SAH tree where g++ exists, else the LBVH) the queries walk it,
    without one they take brute force: the JAX scene's hits either way
    (ids and occlusion equal, t within 1e-6). The JAX scene's hits on the
    CPU past 512 triangles are its LBVH walk (intersect.py:119-128), here
    called directly."""
    scene, jgeom, jtri_mat = _knot_scene(monkeypatch, with_bvh)
    assert not scene.has_clusters and scene.has_bvh == with_bvh
    if with_bvh:
        arrays = native.build_bvh_sah(scene.geom)
        want = (lbvh.build_lbvh(scene.geom) if arrays is None
                else lbvh.LBVH.from_numpy(arrays, "cpu"))
        for f in NODE_FIELDS:
            assert torch.equal(getattr(scene.bvh, f), getattr(want, f)), f
    walks = []
    real = trav.traverse
    monkeypatch.setattr(trav, "traverse",
                        lambda *a, **k: walks.append(1) or real(*a, **k))
    o, d, tmin, tmax = random_rays(1200, 3)
    o = o * 3.0
    jr, tr = both_rays(o, d, tmin, tmax)
    hits = intersect.scene_closest(scene, tr)
    occ = intersect.scene_any(scene, tr)
    assert len(walks) == (2 if with_bvh else 0)
    jb = jax_bvh(lbvh.build_lbvh(scene.geom))
    jh = jtraverse(jb, jgeom, jtri_mat, jr)
    assert np.array_equal(hits.prim_id.numpy(), np.asarray(jh.prim_id))
    assert np.array_equal(hits.mat_id.numpy(), np.asarray(jh.mat_id))
    np.testing.assert_allclose(hits.t.numpy(), np.asarray(jh.t), rtol=1e-6,
                               atol=1e-6)
    assert np.array_equal(occ.numpy(), np.asarray(
        jtraverse(jb, jgeom, None, jr, any_hit=True)))
    assert int(hits.valid.sum()) > 50
