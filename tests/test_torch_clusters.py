"""The port's cluster-culled traversal (optix_raytracer_tpu_torch.accel.clusters:
the table, the culls and the plain versions of kernels 4-6) against the JAX
package's accel/clusters.py on the CPU, its Pallas kernels in interpret mode.

The reference runs with one 256-ray block per grid step (GROUPS = 1,
SUPER = 256, patched for this module only): each ray's result does not
depend on how blocks are grouped into grid steps, and the interpret-mode
compile of 16 unrolled blocks would cost minutes. The port keeps its own
16-block padding; block tables are compared as [n_blocks, c_pad].

Bars: tables, culls, lists, morton codes and sort keys bit-equal; hit and
material ids and occlusion equal; t within rtol 1e-5, uv atol 1e-4,
normals atol 1e-5 (tests/test_pallas_intersect.py): XLA on the CPU fuses
multiply-adds that the port rounds separately, so t / uv / normals agree to
a few ulps, not bit for bit.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_raytracer_tpu.accel import clusters as jcl
from optix_raytracer_tpu.accel import morton as jmorton
from optix_raytracer_tpu.accel import native as jnative
from optix_raytracer_tpu.accel.geometry import build_triangle_geometry as jgeom
from optix_raytracer_tpu.core.rays import Rays as JRays
from optix_raytracer_tpu.scene import builtins as jbuiltins
from optix_raytracer_tpu_torch.accel import clusters as tcl
from optix_raytracer_tpu_torch.accel import morton as tmorton
from optix_raytracer_tpu_torch.accel import native as tnative
from optix_raytracer_tpu_torch.accel.geometry import build_triangle_geometry
from optix_raytracer_tpu_torch.core.rays import Rays
from optix_raytracer_tpu_torch.scene import builtins as tbuiltins
from optix_raytracer_tpu_torch.scene import device_scene as tds

from torch_parity import jax_native_sah, scene_fields, torch_scene  # noqa: F401

# The port's own knot build is compared with the JAX package's, which takes
# the SAH order only with its native SAH library loaded.
pytestmark = pytest.mark.usefixtures("jax_native_sah")


@pytest.fixture(scope="module", autouse=True)
def one_block_per_step():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcl, "GROUPS", 1)
        mp.setattr(jcl, "SUPER", jcl.SUB)
        jax.clear_caches()
        yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def knot():
    js = jbuiltins.knot_scene(20, 14)     # 562 triangles, 5 clusters
    return js, torch_scene(js)


def ray_set(n=4096, seed=3, dead_every=7):
    """Rays from around the knot toward random points near it, mixed
    lengths, every `dead_every`-th ray with an empty window, and one whole
    block (rays 512-767) dead."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    target = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(n, 1e-3, np.float32)
    tmax = rng.choice([1e16, 5.0, 9.0], n).astype(np.float32)
    tmax[::dead_every] = 0.0
    tmax[512:768] = tmin[512:768]
    return o, d.astype(np.float32), tmin, tmax


def jrays(arrs):
    return JRays(*(jnp.asarray(a) for a in arrs))


def trays(arrs):
    return Rays(*(torch.as_tensor(a) for a in arrs))


def as_blocks(a, c_pad):
    return np.asarray(a).reshape(-1, c_pad)


def assert_hits_match(th, jh):
    np.testing.assert_array_equal(th.prim_id.numpy(), np.asarray(jh.prim_id))
    np.testing.assert_array_equal(th.mat_id.numpy(), np.asarray(jh.mat_id))
    np.testing.assert_array_equal(th.inst_id.numpy(), np.asarray(jh.inst_id))
    hit = th.prim_id.numpy() >= 0
    assert hit.any() and (~hit).any()
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), rtol=1e-5)
    np.testing.assert_allclose(th.uv.numpy(), np.asarray(jh.uv), atol=1e-4)
    np.testing.assert_allclose(th.normal.numpy(), np.asarray(jh.normal),
                               atol=1e-5)


# --- tables ----------------------------------------------------------------

def test_build_clusters_bit_equal_same_order(knot):
    """The SAH order of the JAX scene, and the morton order, on the JAX
    geometry: comp, aabb and slot_prim bit-equal."""
    js, ts = knot
    n = ts.num_triangles
    order = np.asarray(js.clusters.slot_prim)[:n]
    for jref, own in (
            (js.clusters, tcl.build_clusters(ts.geom, ts.tri_mat,
                                             order=order)),
            (jcl.build_clusters(js.geom, js.tri_mat),
             tcl.build_clusters(ts.geom, ts.tri_mat))):
        assert own.num_clusters == jref.num_clusters == 5
        for k in ("comp", "aabb", "slot_prim"):
            np.testing.assert_array_equal(getattr(own, k).numpy(),
                                          np.asarray(getattr(jref, k)))


def test_own_knot_scene_matches_jax(knot):
    """The port's own knot build: the same SAH order, AABBs and ids bit for
    bit; the Woop constants within the geometry's 1e-6 (test_torch_core)."""
    js, _ = knot
    own = tbuiltins.knot_scene(20, 14, device="cpu")
    ref = scene_fields(js)
    assert own.geom.smooth and own.has_clusters
    for key, val in (("cluster_aabb", own.clusters.aabb),
                     ("cluster_slot_prim", own.clusters.slot_prim),
                     ("tri_mat", own.tri_mat), ("v0", own.geom.v0),
                     ("e1", own.geom.e1), ("e2", own.geom.e2),
                     ("corner_normal", own.geom.corner_normal),
                     ("light_corner", own.area_light.corner),
                     ("light_v1", own.area_light.v1),
                     ("light_v2", own.area_light.v2),
                     ("light_emission", own.area_light.emission)):
        np.testing.assert_array_equal(val.numpy(), ref[key], err_msg=key)
    comp, jcomp = own.clusters.comp.numpy(), ref["cluster_comp"]
    np.testing.assert_array_equal(comp[:, 16:], jcomp[:, 16:])
    scale = np.abs(jcomp[:, :16]).max(axis=1, keepdims=True) + 1e-30
    np.testing.assert_allclose(comp[:, :16] / scale, jcomp[:, :16] / scale,
                               atol=1e-6)
    np.testing.assert_allclose(own.area_light.normal.numpy(),
                               ref["light_normal"], atol=1e-7)
    assert own.num_triangles == 562 and own.clusters.num_clusters == 5


def test_knot_builtins_match_jax():
    for args in ((20, 14), (7, 5)):
        for a, b in zip(tbuiltins.trefoil_mesh(*args),
                        jbuiltins.trefoil_mesh(*args)):
            np.testing.assert_array_equal(a, b)
    assert tbuiltins.KNOT_MATERIALS == [
        {"kind": 0, "base_color": (0.75, 0.55, 0.25)},
        {"kind": 0, "base_color": (0.65, 0.65, 0.70)}]
    t, j = tbuiltins.knot_camera(64, 48), jbuiltins.knot_camera(64, 48)
    for f in ("eye", "lookat", "up", "fov_y", "aspect"):
        assert getattr(t, f) == getattr(j, f)


def test_sah_leaf_order_matches_jax(knot):
    js, ts = knot
    assert tnative.available() == jnative.available()
    own = tnative.sah_leaf_order(ts.geom)
    ref = jnative.sah_leaf_order(js.geom)
    if ref is None:
        assert own is None
    else:
        np.testing.assert_array_equal(own, ref)


def test_scene_builds_clusters_like_jax():
    """Clusters past 512 triangles only; past the supercluster tier's
    1024 x 32 clusters no table is built, as the reference builds none
    there and falls back to its LBVH (the port's too, tests/
    test_torch_lbvh.py). A smaller smooth mesh has no table and renders."""
    small = tbuiltins.cornell_box("cpu")
    assert not small.has_clusters and small.clusters is None
    big = types.SimpleNamespace(num_triangles=1024 * 32 * 128 + 1)
    assert tds._build_cluster_table(big, None) is None
    verts, idx, normals = tbuiltins.trefoil_mesh(8, 6)    # 96 smooth tris
    scene = tds.make_device_scene(verts, idx, np.zeros(96, np.int32),
                                  [{"kind": 0}], "cpu", normals=normals)
    assert not scene.has_clusters and scene.geom.smooth
    scene.require_supported()     # shading_frame interpolates its normals


# --- morton, keys, culls ---------------------------------------------------

def test_morton_and_expand_bits_match_jax():
    rng = np.random.default_rng(5)
    v = rng.integers(0, 1024, 5000).astype(np.uint32)
    np.testing.assert_array_equal(
        tmorton.expand_bits(torch.as_tensor(v.astype(np.int64))).numpy(),
        np.asarray(jmorton.expand_bits(jnp.asarray(v))).astype(np.int64))
    pts = rng.uniform(-2, 3, (5000, 3)).astype(np.float32)
    pts[:10] = [[-2, -2, -2]] * 5 + [[3, 3, 3]] * 5    # the clamped corners
    lo = np.array([-1.5, -2.0, -1.0], np.float32)
    hi = np.array([2.5, 2.0, 3.0], np.float32)
    own = tmorton.morton3d(torch.as_tensor(pts), torch.as_tensor(lo),
                           torch.as_tensor(hi)).numpy()
    ref = np.asarray(jmorton.morton3d(jnp.asarray(pts), jnp.asarray(lo),
                                      jnp.asarray(hi))).astype(np.int64)
    np.testing.assert_array_equal(own, ref)
    assert own.max() < 2 ** 30


def test_coherence_key_matches_jax(knot):
    js, ts = knot
    arrs = ray_set()
    own = tcl.coherence_key(ts.clusters, trays(arrs)).numpy()
    ref = np.asarray(jcl.coherence_key(js.clusters, jrays(arrs)))
    np.testing.assert_array_equal(own, ref.astype(np.int64))
    assert (own[arrs[3] <= arrs[2]] == 0xFFFFFFFF).all()


def test_pack_rays_matches_jax():
    arrs = ray_set(n=1000)
    np.testing.assert_array_equal(
        tcl._pack_rays(trays(arrs), 4096).numpy(),
        np.asarray(jcl._pack_rays(jrays(arrs), 4096)))


def test_exact_cull_plain_matches_pallas(knot):
    """Kernel 4's plain version vs _exact_cull_kernel (interpret): tn and gm
    bit-equal, with an all-dead block and blocks with dead lanes."""
    js, ts = knot
    arrs = ray_set()
    packed = tcl._pack_rays(trays(arrs), 4096)
    c_pad = ts.clusters.c_pad
    tn, gm = tcl.exact_cull_plain(ts.clusters.aabb, packed, 16, c_pad)
    mask, tnear, gmask = jcl._exact_block_cull(
        js.clusters, jnp.asarray(packed.numpy()), 16, c_pad, interpret=True)
    jm = np.asarray(mask)
    np.testing.assert_array_equal(tn.numpy() < tcl._BIG, jm)
    np.testing.assert_array_equal(tn.numpy()[jm], np.asarray(tnear)[jm])
    np.testing.assert_array_equal(gm.numpy(), np.asarray(gmask))
    assert (gm.numpy()[2] == 0).all() and (tn.numpy()[2] == tcl._BIG).all()
    assert ((gm.numpy() > 0) & (gm.numpy() < 0xFF)).any()   # partial groups
    assert jm[:, :5].sum() > 0


@pytest.mark.parametrize("exact", [False, True])
def test_block_cull_and_cull_match_jax(knot, exact):
    js, ts = knot
    arrs = ray_set()
    packed = tcl._pack_rays(trays(arrs), 4096)
    jpacked = jnp.asarray(packed.numpy())
    c_pad = ts.clusters.c_pad
    if not exact:
        mask, tnear = tcl._block_cull(ts.clusters, packed, 16, c_pad)
        jmask, jtnear = jcl._block_cull(js.clusters, jpacked, 16, c_pad)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        np.testing.assert_array_equal(tnear.numpy(), np.asarray(jtnear))
    own = tcl._cull(ts.clusters, packed, 1, c_pad, exact=exact)
    ref = jcl._cull(js.clusters, jpacked, 16, c_pad, True, exact=exact)
    for a, b in zip(own, ref):
        np.testing.assert_array_equal(as_blocks(a.numpy(), a.shape[-1]),
                                      as_blocks(b, a.shape[-1]))
    counts = own[0].numpy().ravel()
    assert counts.max() > 0 and (counts[2] == 0) == exact   # dead block
    gm = (own[1].numpy() >> 16) & 0xFF
    assert exact == bool((gm != 0xFF).any())


def test_traversal_stats_match_jax(knot):
    js, ts = knot
    arrs = ray_set()
    own = tcl.traversal_stats(ts.clusters, trays(arrs))
    ref = jcl.traversal_stats(js.clusters, jrays(arrs), interpret=True)
    assert own == pytest.approx(ref, rel=1e-12)


def test_hits_from_rows_matches_jax():
    rng = np.random.default_rng(4)
    rows = rng.normal(size=(300, 8)).astype(np.float32)
    rows[:, 6:8] = rng.integers(-1, 40, (300, 2))
    rows[:50, 3:6] = 0.0                       # degenerate normals
    rows[50:60, 3:6] = 1e-9
    live = rng.random(300) > 0.2
    tmax = rng.uniform(1, 9, 300).astype(np.float32)
    own = tcl._hits_from_rows(torch.as_tensor(rows), torch.as_tensor(live),
                              torch.as_tensor(tmax))
    ref = jcl._hits_from_rows(jnp.asarray(rows), jnp.asarray(live),
                              jnp.asarray(tmax))
    for f in ("t", "prim_id", "inst_id", "mat_id", "uv"):
        np.testing.assert_array_equal(getattr(own, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    np.testing.assert_allclose(own.normal.numpy(), np.asarray(ref.normal),
                               atol=1e-6)
    assert (own.normal.numpy()[:60] == 0).all()


# --- the walks -------------------------------------------------------------

@pytest.mark.parametrize("exact,group_walk",
                         [(False, False), (True, False), (True, True)])
def test_closest_and_any_hit_match_pallas(knot, exact, group_walk):
    js, ts = knot
    arrs = ray_set()
    jr, tr = jrays(arrs), trays(arrs)
    assert_hits_match(
        tcl.closest_hit(ts.clusters, tr, exact=exact, group_walk=group_walk),
        jcl.closest_hit(js.clusters, jr, interpret=True, exact=exact,
                        group_walk=group_walk))
    own = tcl.any_hit(ts.clusters, tr, exact=exact, group_walk=group_walk)
    ref = jcl.any_hit(js.clusters, jr, interpret=True, exact=exact,
                      group_walk=group_walk)
    np.testing.assert_array_equal(own.numpy(), np.asarray(ref))
    assert own.any() and not own.all()


@pytest.mark.parametrize("group_walk", [False, True])
def test_sorted_queries_match_pallas(knot, group_walk):
    js, ts = knot
    arrs = ray_set(n=3000, seed=8)
    jr, tr = jrays(arrs), trays(arrs)
    assert_hits_match(
        tcl.closest_hit_sorted(ts.clusters, tr, group_walk=group_walk),
        jcl.closest_hit_sorted(js.clusters, jr, interpret=True,
                               group_walk=group_walk))
    np.testing.assert_array_equal(
        tcl.any_hit_sorted(ts.clusters, tr, group_walk=group_walk).numpy(),
        np.asarray(jcl.any_hit_sorted(js.clusters, jr, interpret=True,
                                      group_walk=group_walk)))


def test_stream_tier_dispatch_matches_pallas(knot, monkeypatch):
    """MAX_CLUSTERS = 2 on both sides: the interval cull (0xFF group bits)
    and the streaming walk, ungated even when asked for exact + gating."""
    js, ts = knot
    monkeypatch.setattr(jcl, "MAX_CLUSTERS", 2)
    monkeypatch.setattr(tcl, "MAX_CLUSTERS", 2)
    arrs = ray_set(n=2000, seed=9)
    jr, tr = jrays(arrs), trays(arrs)
    counts, lists, _ = tcl._cull(ts.clusters, tcl._pack_rays(tr, 4096), 1,
                                 ts.clusters.c_pad, exact=True)
    assert ((lists.numpy() >> 16) == 0xFF).all()
    assert_hits_match(
        tcl.closest_hit(ts.clusters, tr, exact=True, group_walk=True),
        jcl.closest_hit(js.clusters, jr, interpret=True, exact=True,
                        group_walk=True))
    np.testing.assert_array_equal(
        tcl.any_hit(ts.clusters, tr, exact=True).numpy(),
        np.asarray(jcl.any_hit(js.clusters, jr, interpret=True, exact=True)))


def test_tie_rule_matches_pallas():
    """Every triangle twice, in clusters of their own: equal t in two
    clusters and in two lanes. The reference's per-lane running minimum with
    a strict `<` and its lowest-winning-lane pick decide which copy wins;
    the plain walk must pick the same one."""
    rng = np.random.default_rng(12)
    m = 150
    v0 = rng.uniform(-1, 1, (m, 3))
    verts = np.concatenate([v0, v0 + rng.uniform(-.6, .6, (m, 3)),
                            v0 + rng.uniform(-.6, .6, (m, 3))]).astype(
                                np.float32)
    idx = np.arange(3 * m).reshape(3, m).T
    idx = np.concatenate([idx, idx]).astype(np.int32)        # duplicates
    order = np.concatenate([np.arange(m, 2 * m), rng.permutation(m)]
                           ).astype(np.int32)
    g = build_triangle_geometry(verts, idx, "cpu")
    jg = jgeom(verts, idx)
    tri_mat = np.arange(2 * m, dtype=np.int32) % 7
    own_cl = tcl.build_clusters(g, torch.as_tensor(tri_mat), order=order)
    ref_cl = jcl.build_clusters(jg, jnp.asarray(tri_mat), order=order)
    arrs = ray_set(n=2048, seed=13, dead_every=11)
    assert_hits_match(tcl.closest_hit(own_cl, trays(arrs)),
                      jcl.closest_hit(ref_cl, jrays(arrs), interpret=True))
    prim = tcl.closest_hit(own_cl, trays(arrs)).prim_id.numpy()
    assert (prim[prim >= 0] >= m).any() and (prim[prim >= 0] < m).any()


def test_wrappers_need_cuda_or_cpu(knot):
    _, ts = knot
    meta = torch.device("meta")
    packed = torch.zeros((4096, 8), device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        tcl.exact_cull(ts.clusters.aabb.to(meta), packed, 16, 128)
    counts = torch.zeros((1, 16, 1), dtype=torch.int32, device=meta)
    lists = torch.zeros((1, 16, 128), dtype=torch.int32, device=meta)
    for fn in (tcl.walk_closest, tcl.walk_any):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(counts, lists, lists.float(), ts.clusters.comp.to(meta),
               ts.clusters.aabb.to(meta), packed, False)
