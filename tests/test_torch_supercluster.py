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
import torch_parity
from torch_parity import (jax_native_sah, one_torch_thread,  # noqa: F401
                         torch_scene)

# The JAX knots here are built through the reference's SAH library, which
# builds itself in place; the fixture builds it first, atomically, under a
# lock (torch_parity.jax_native_sah).
pytestmark = pytest.mark.usefixtures("jax_native_sah")

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
    MAX_SUPERCLUSTERS superclusters a query of such a table raises, and
    the build makes none (the scene walks its BVH)."""
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
    with pytest.raises(NotImplementedError, match="walks its BVH"):
        tcl.closest_hit(cl, rays)
    assert tds._build_cluster_table(
        types.SimpleNamespace(num_triangles=2 * 2 * 128 + 1), None) is None


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


# ---------------------------------------------------------------------------
# The pair admission rule of kernels 5c / 6c (sc_admitted_pairs_plain): the
# plain walks restricted to the admitted pairs (admitted=True, the kernels'
# work) must give the block-union walks' rows and occlusion bit for bit.
# ---------------------------------------------------------------------------

def _admitted_vs_block_union(cl, arrs, exact):
    """Both walks of one ray set at cl's supercluster tier → (rows, occ) of
    the block-union walks, after holding the admitted walks to them."""
    packed = tcl._pack_rays(trays(arrs), tcl._padded(arrs[0].shape[0]))
    counts, lists, tnear, member = tcl._tier_cull(cl, packed, exact)
    assert member is not None and int(counts.max()) > 0
    args = (counts, lists, tnear, cl.comp, member, packed)
    rows = tcl.walk_sc_closest_plain(*args)
    rows_a = tcl.walk_sc_closest_plain(*args, admitted=True)
    np.testing.assert_array_equal(rows_a.view(torch.int32).numpy(),
                                  rows.view(torch.int32).numpy())
    occ = tcl.walk_sc_any_plain(*args)
    np.testing.assert_array_equal(
        tcl.walk_sc_any_plain(*args, admitted=True).numpy(), occ.numpy())
    return rows, occ


def _arrs(rays8):
    """[N, 8] rays → ray_set's (o, d, tmin, tmax)."""
    return (rays8[:, 0:3].copy(), rays8[:, 3:6].copy(), rays8[:, 6].copy(),
            rays8[:, 7].copy())


@pytest.mark.parametrize("exact", [False, True])
def test_admitted_walks_match_block_union(tier, exact):
    for arrs in (ray_set(n=1024, seed=41), _arrs(_member_rays(3))):
        rows, occ = _admitted_vs_block_union(tier.tcl, arrs, exact)
        assert (rows[:, 6] >= 0).any() and occ.any()


def test_admitted_walks_match_on_grazing_rays(tier):
    _, member, _ = tcl._sc_tables(tier.tcl)
    rays8 = torch_parity.sc_grazing_rays(tier.ts.geom, tier.tcl, member,
                                         seed=tier.sc)
    assert (rays8[:, 3:6] == 0).any() and len(rays8) >= 380
    for exact in (False, True):
        rows, occ = _admitted_vs_block_union(tier.tcl, _arrs(rays8), exact)
        assert (rows[:, 6] >= 0).any() and occ.any()


def test_admission_keeps_every_accepted_pair(tier):
    """Every (ray, member) pair of the block union whose Woop test accepts a
    hit on the grazing and random sets (one block each) is admitted (at the
    ray's tmax as its best t), no pair outside it is, and the widening adds
    few pairs to the unwidened crossings."""
    _, member, n_sc = tcl._sc_tables(tier.tcl)
    rays8 = np.concatenate([
        torch_parity.sc_grazing_rays(tier.ts.geom, tier.tcl, member, seed=5),
        _member_rays(4)])
    a = torch.as_tensor(rays8)[None].expand(n_sc, -1, -1)
    boxes = member[:n_sc]
    adm = tcl.sc_admitted_pairs_plain(a, boxes, a[:, :, 7])
    cross = tcl._member_cross(a, boxes)
    accepted = torch.zeros_like(adm)
    for c in range(tier.sc):
        rows = torch.arange(n_sc) * tier.sc + c
        ok, _, _, _ = tcl._pair_ok(tier.tcl.comp[rows], a, None, False)
        accepted[:, :, c] = ok.any(dim=2)
    union = cross.any(dim=1, keepdim=True)     # the plain walks' members
    assert (accepted & union).any()
    assert not (accepted & union & ~adm).any()
    assert not (adm & ~union).any()
    real = (member[:n_sc, 0:3] <= member[:n_sc, 3:6]).all(dim=1)
    widened_only = int((adm & ~cross).sum())
    assert widened_only <= 0.25 * int((cross & real[:, None]).sum())


def test_admitted_walks_keep_the_tie_rule(monkeypatch):
    """Exact ties at t = 1 (torch_parity.sc_tie_case): the earlier visit
    wins at an equal slot, the lower slot over the earlier visit, in one
    member and across members; the admitted walks agree bit for bit."""
    monkeypatch.setattr(tcl, "MAX_STREAM_CLUSTERS", 2)
    monkeypatch.setattr(tcl, "SC_CLUSTERS", 2)
    geom, tri_mat, order, rays8, expect = torch_parity.sc_tie_case()
    cl = tcl.build_clusters(geom, tri_mat, order=order)
    assert cl.comp.shape[0] == 6 and cl.num_clusters == 6
    for exact in (False, True):
        rows, _ = _admitted_vs_block_union(cl, _arrs(rays8), exact)
        n = len(rays8)
        prim = rows[:n, 6].numpy().astype(np.int64)
        assert (prim >= 0).all() and (rows[:n, 0].numpy() == 1.0).all()
        check = expect >= 0
        np.testing.assert_array_equal(prim[check], expect[check])


def test_admitted_walks_at_full_width(knot9k, monkeypatch):
    """The real 32 members (knot9k): the admitted walks equal the
    block-union walks on random and grazing rays."""
    monkeypatch.setattr(tcl, "MAX_STREAM_CLUSTERS", 2)
    cl = knot9k.clusters
    _, member, _ = tcl._sc_tables(cl)
    grazing = torch_parity.sc_grazing_rays(knot9k.geom, cl, member, seed=9,
                                           boxes=24)
    for arrs, exact in ((ray_set(n=768, seed=43), False),
                        (_arrs(grazing), True)):
        rows, occ = _admitted_vs_block_union(cl, arrs, exact)
        assert (rows[:, 6] >= 0).any() and occ.any()


def test_grazing_rays_reach_the_margin(knot9k, monkeypatch):
    """At the real 32 members the grazing set (one block) holds accepted
    pairs of the block union that the unwidened slab test misses: with the
    margin at 0 the rule would drop some, with the stated margin none."""
    monkeypatch.setattr(tcl, "MAX_STREAM_CLUSTERS", 2)
    cl = knot9k.clusters
    _, member, n_sc = tcl._sc_tables(cl)
    a = torch.as_tensor(np.concatenate([
        torch_parity.sc_grazing_rays(knot9k.geom, cl, member, seed=s,
                                     boxes=71) for s in range(4)]))
    a = a[None].expand(n_sc, -1, -1)
    accepted = torch.stack([
        tcl._pair_ok(cl.comp[torch.arange(n_sc) * 32 + c], a, None,
                     False)[0].any(dim=2) for c in range(32)], dim=2)
    dropped = {}
    for margin in ("stated", "zero"):
        if margin == "zero":
            monkeypatch.setattr(tcl, "SC_MARGIN_REL", 0.0)
            monkeypatch.setattr(tcl, "SC_MARGIN_FLOOR", 0.0)
        adm = tcl.sc_admitted_pairs_plain(a, member[:n_sc], a[:, :, 7])
        union = tcl._member_cross(a, member[:n_sc]).any(dim=1, keepdim=True)
        dropped[margin] = int((accepted & union & ~adm).sum())
    assert dropped == {"stated": 0, "zero": dropped["zero"]}
    assert dropped["zero"] > 0


def test_admitted_walks_keep_to_the_block_union(knot9k, monkeypatch):
    """A ray alone in its block whose accepted hit lies in a member its own
    slab test misses (torch_parity.sc_lone_grazing_rays): the plain walks
    never test that member, so neither may the rule. The admitted walks
    equal the block-union walks; the rule without its block-union term
    would not."""
    monkeypatch.setattr(tcl, "MAX_STREAM_CLUSTERS", 2)
    cl = knot9k.clusters
    _, member, _ = tcl._sc_tables(cl)
    rays8 = torch_parity.sc_lone_grazing_rays(knot9k.geom, cl, member)
    assert len(rays8) >= 10 * 256
    rule = tcl.sc_admitted_pairs_plain

    def widened_only(a, boxes, best_t=None):
        lo, hi, real = tcl.sc_widened_boxes(boxes)
        cross, tn = tcl._slab_cross(a, lo, hi)
        adm = cross & real[:, None, :]
        return adm if best_t is None else adm & (tn <= best_t[:, :, None])

    for exact in (False, True):
        rows, occ = _admitted_vs_block_union(cl, _arrs(rays8), exact)
        packed = tcl._pack_rays(trays(_arrs(rays8)),
                                tcl._padded(len(rays8)))
        args = (*tcl._tier_cull(cl, packed, exact)[:3], cl.comp,
                tcl._sc_tables(cl)[1], packed)
        monkeypatch.setattr(tcl, "sc_admitted_pairs_plain", widened_only)
        wide = tcl.walk_sc_closest_plain(*args, admitted=True)
        wide_occ = tcl.walk_sc_any_plain(*args, admitted=True)
        monkeypatch.setattr(tcl, "sc_admitted_pairs_plain", rule)
        assert not torch.equal(wide, rows) and not torch.equal(wide_occ, occ)
