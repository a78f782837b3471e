"""The port's supercluster tier (optix_raytracer_tpu_torch.accel.clusters:
`_sc_tables`, `_sc_facade`, `_member_cross`, the integer member mask and the
plain versions of kernels 5c / 6c) against the JAX package's accel/clusters.py
on the CPU, its Pallas kernels in interpret mode.

The tier is forced onto small knots by lowering the caps in both packages
(MAX_STREAM_CLUSTERS = 2, SC_CLUSTERS = 2 or 8); both read them at call
time. The reference runs one 256-ray block per grid step (GROUPS = 1, see
test_torch_clusters.py). The reference is held only at SC_CLUSTERS <= 8: its
`_member_bits` packs the member mask with f32 `exp2` weights, which XLA:CPU
does not compute exactly for every bit past 13 members. At the real 32
members the port's tier is held to its own resident tier and to brute force.

Bars (test_torch_clusters.py): tables and member crossings bit-equal; hit
and material ids and occlusion equal; t within rtol 1e-5, uv atol 1e-4,
normals atol 1e-5.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_raytracer_tpu.accel import clusters as jcl
from optix_raytracer_tpu.scene import builtins as jbuiltins
from optix_raytracer_tpu_torch.accel import bruteforce as tbf
from optix_raytracer_tpu_torch.accel import clusters as tcl
from optix_raytracer_tpu_torch.scene import builtins as tbuiltins
from optix_raytracer_tpu_torch.scene import device_scene as tds

from test_torch_clusters import assert_hits_match, jrays, ray_set, trays
from torch_parity import one_torch_thread, torch_scene  # noqa: F401

# (SC_CLUSTERS, knot segments, sides): 5 clusters → 3 superclusters of 2;
# 18 clusters → 3 superclusters of 8.
TIERS = [(2, 20, 14), (8, 40, 28)]


@pytest.fixture(scope="module")
def knots():
    out = {}
    for _, seg, sides in TIERS:
        js = jbuiltins.knot_scene(seg, sides)
        out[(seg, sides)] = (js, torch_scene(js))
    return out


def _patch_tier(mp, sc, max_stream=2):
    for mod in (jcl, tcl):
        mp.setattr(mod, "MAX_STREAM_CLUSTERS", max_stream)
        mp.setattr(mod, "SC_CLUSTERS", sc)
    mp.setattr(jcl, "GROUPS", 1)
    mp.setattr(jcl, "SUPER", jcl.SUB)


@pytest.fixture(params=TIERS, ids=["sc2", "sc8"])
def tier(request, knots):
    """Both packages at the supercluster tier, and each one's cluster table
    of the knot built there in the JAX scene's SAH order."""
    sc, seg, sides = request.param
    js, ts = knots[(seg, sides)]
    with pytest.MonkeyPatch.context() as mp:
        _patch_tier(mp, sc)
        jax.clear_caches()
        order = np.asarray(js.clusters.slot_prim)[:ts.num_triangles]
        jref = jcl.build_clusters(js.geom, js.tri_mat, order=order)
        own = tcl.build_clusters(ts.geom, ts.tri_mat, order=order)
        assert own.num_clusters > tcl.MAX_STREAM_CLUSTERS
        assert own.comp.shape[0] == jref.comp.shape[0]
        assert own.comp.shape[0] // sc == 3
        yield types.SimpleNamespace(sc=sc, jcl=jref, tcl=own, ts=ts)
    jax.clear_caches()


def test_sc_tables_bit_equal(tier):
    cull, member, n_sc = tcl._sc_tables(tier.tcl)
    jcull, jmember, jn_sc = jcl._sc_tables(tier.jcl)
    assert n_sc == jn_sc == 3
    np.testing.assert_array_equal(cull.numpy(), np.asarray(jcull))
    assert member.shape == (128, 6, tier.sc)
    np.testing.assert_array_equal(member.numpy(),
                                  np.asarray(jmember)[:, :, :tier.sc])
    facade = tcl._sc_facade(tier.tcl, cull, n_sc)
    assert facade.num_clusters == 3 and facade.c_pad == 128
    assert facade.comp.shape[0] == 0


def _member_rays(seed):
    """256 rays through the knot's box: some direction components +0.0 and
    -0.0 (the pseudo-inverse's two fills), origins inside and outside, dead
    rays (empty windows) and short windows."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, (256, 3)).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[0:40, 0] = 0.0
    d[40:80, 1] = -0.0
    d[80:100, 2] = -0.0
    d[100:110, 0:2] = 0.0
    tmin = np.full(256, 1e-3, np.float32)
    tmax = rng.choice([1e16, 1.0, 4.0], 256).astype(np.float32)
    tmax[::9] = 0.0
    return np.concatenate([o, d, tmin[:, None], tmax[:, None]],
                          axis=1).astype(np.float32)


def test_member_cross_bit_equal(tier):
    _, member, n_sc = tcl._sc_tables(tier.tcl)
    _, jmember, _ = jcl._sc_tables(tier.jcl)
    sc = tier.sc
    crossed = 0
    for seed in (1, 2):
        a = _member_rays(seed)
        assert (np.signbit(a[:, 3:6]) & (a[:, 3:6] == 0)).any()
        own = tcl._member_cross(torch.as_tensor(a)[None].expand(n_sc, -1, -1),
                                member[:n_sc]).numpy()
        for s in range(n_sc):
            ref = np.asarray(jcl._member_cross(jnp.asarray(a), jmember[s]))
            np.testing.assert_array_equal(own[s], ref[:, :sc])
        assert not own[:, a[:, 7] <= a[:, 6]].any()       # dead rays
        crossed += own.sum()
    assert 0 < crossed < 2 * n_sc * 256 * sc


def test_member_bits_round_trip_ascending():
    """Integer member masks: every single bit 0-31 and 10,000 random 32-bit
    masks survive crossings → mask, and each block pops its members in
    ascending order."""
    rng = np.random.default_rng(0)
    masks = np.concatenate([1 << np.arange(32, dtype=np.int64),
                            rng.integers(0, 1 << 32, 10000, dtype=np.int64),
                            [0, (1 << 32) - 1]])
    bits = (masks[:, None] >> np.arange(32)) & 1                 # [B, 32]
    cross = np.zeros((len(masks), 3, 32), bool)
    cross[:, 1] = bits.astype(bool)          # one ray of three crosses
    got = tcl._member_bits(torch.as_tensor(cross))
    np.testing.assert_array_equal(got.numpy(), masks)
    seen = [[] for _ in masks]

    def visit(sel, c):
        for blk, member in zip(sel.tolist(), c.tolist()):
            seen[blk].append(member)

    tcl._for_each_set_member(got, visit)
    for m, members in zip(masks.tolist(), seen):
        assert members == sorted(members) == [c for c in range(32)
                                              if m >> c & 1]


@pytest.mark.parametrize("exact", [False, True])
def test_queries_match_pallas(tier, exact):
    """closest_hit and any_hit at the supercluster tier (the interval cull,
    and the exact cull at supercluster granularity) against the Pallas sc
    kernels in interpret mode."""
    arrs = ray_set(n=2048, seed=21)
    jr, tr = jrays(arrs), trays(arrs)
    assert_hits_match(tcl.closest_hit(tier.tcl, tr, exact=exact),
                      jcl.closest_hit(tier.jcl, jr, interpret=True,
                                      exact=exact))
    own = tcl.any_hit(tier.tcl, tr, exact=exact)
    np.testing.assert_array_equal(
        own.numpy(), np.asarray(jcl.any_hit(tier.jcl, jr, interpret=True,
                                            exact=exact)))
    assert own.any() and not own.all()


def test_sorted_queries_and_stats_match_pallas(tier):
    arrs = ray_set(n=1500, seed=22)
    jr, tr = jrays(arrs), trays(arrs)
    assert_hits_match(tcl.closest_hit_sorted(tier.tcl, tr),
                      jcl.closest_hit_sorted(tier.jcl, jr, interpret=True))
    np.testing.assert_array_equal(
        tcl.any_hit_sorted(tier.tcl, tr).numpy(),
        np.asarray(jcl.any_hit_sorted(tier.jcl, jr, interpret=True)))
    own = tcl.traversal_stats(tier.tcl, tr)
    assert own == pytest.approx(
        jcl.traversal_stats(tier.jcl, jr, interpret=True), rel=1e-12)
    assert own["mean_tris_tested_per_ray"] == pytest.approx(
        own["mean_clusters_per_block"] * tier.sc * 128)


@pytest.fixture(scope="module")
def knot9k():
    """knot_scene(90, 50): 9,002 triangles, 71 clusters, built as 96 rows
    (3 superclusters of 32) with the stream cap lowered to 2."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcl, "MAX_STREAM_CLUSTERS", 2)
        scene = tbuiltins.knot_scene(90, 50, device="cpu")
    assert scene.clusters.num_clusters == 71
    assert scene.clusters.comp.shape[0] == 96
    return scene


@pytest.mark.parametrize("exact", [False, True])
def test_full_width_tier_matches_resident_and_brute_force(knot9k,
                                                          monkeypatch, exact):
    """At the real 32 members, where the reference's packing is not exact:
    the supercluster tier's hits and occlusion equal the resident tier's on
    the same table and brute force's."""
    cl = knot9k.clusters
    arrs = ray_set(n=512, seed=31)
    rays = trays(arrs)
    monkeypatch.setattr(tcl, "MAX_STREAM_CLUSTERS", 2)
    members = []
    sc_walk = tcl.walk_sc_closest_plain

    def spy(counts, lists, tnear, comp, member, packed, **kw):
        members.append(member.shape[2])
        return sc_walk(counts, lists, tnear, comp, member, packed, **kw)

    monkeypatch.setattr(tcl, "walk_sc_closest_plain", spy)
    sc_hits = tcl.closest_hit(cl, rays, exact=exact)
    sc_occ = tcl.any_hit(cl, rays, exact=exact)
    assert members == [32]
    monkeypatch.setattr(tcl, "MAX_STREAM_CLUSTERS", 8192)
    res_hits = tcl.closest_hit(cl, rays, exact=exact)
    res_occ = tcl.any_hit(cl, rays, exact=exact)
    for f in ("prim_id", "mat_id", "t", "uv", "normal"):
        np.testing.assert_array_equal(getattr(sc_hits, f).numpy(),
                                      getattr(res_hits, f).numpy())
    np.testing.assert_array_equal(sc_occ.numpy(), res_occ.numpy())
    bf = tbf.intersect_closest(knot9k.geom, rays, tri_mat=knot9k.tri_mat,
                               chunk_size=None)
    np.testing.assert_array_equal(sc_hits.prim_id.numpy(),
                                  bf.prim_id.numpy())
    np.testing.assert_array_equal(
        sc_occ.numpy(),
        tbf.intersect_any(knot9k.geom, rays, chunk_size=None).numpy())
    hit = sc_hits.prim_id.numpy() >= 0
    assert hit.any() and (~hit).any() and sc_occ.any() and not sc_occ.all()


def test_scene_dispatches_to_sc_walk_and_caps(monkeypatch):
    """make_device_scene past the (lowered) stream cap builds a table of
    whole superclusters and its queries take the sc walks; past
    MAX_SUPERCLUSTERS superclusters both the build and the query raise."""
    monkeypatch.setattr(tcl, "MAX_STREAM_CLUSTERS", 2)
    monkeypatch.setattr(tcl, "SC_CLUSTERS", 2)
    scene = tbuiltins.knot_scene(20, 14, device="cpu")
    cl = scene.clusters
    assert cl.num_clusters == 5 and cl.comp.shape[0] == 6
    calls = []
    for name in ("walk_sc_closest_plain", "walk_sc_any_plain"):
        fn = getattr(tcl, name)
        monkeypatch.setattr(tcl, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.append(_n), _fn(*a, **k))[1])
    rays = trays(ray_set(n=600, seed=5))
    tcl.closest_hit(cl, rays)
    tcl.any_hit(cl, rays, exact=True)
    assert calls == ["walk_sc_closest_plain", "walk_sc_any_plain"]
    monkeypatch.setattr(tcl, "MAX_SUPERCLUSTERS", 2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tcl.closest_hit(cl, rays)
    with pytest.raises(NotImplementedError, match="LBVH"):
        tds._build_cluster_table(
            types.SimpleNamespace(num_triangles=2 * 2 * 128 + 1), None)


def test_sc_wrappers_need_cuda_or_cpu():
    meta = torch.device("meta")
    counts = torch.zeros((1, 16, 1), dtype=torch.int32, device=meta)
    lists = torch.zeros((1, 16, 128), dtype=torch.int32, device=meta)
    comp = torch.zeros((64, 32, 128), device=meta)
    member = torch.zeros((128, 6, 32), device=meta)
    packed = torch.zeros((4096, 8), device=meta)
    for fn in (tcl.walk_sc_closest, tcl.walk_sc_any):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(counts, lists, lists.float(), comp, member, packed)
