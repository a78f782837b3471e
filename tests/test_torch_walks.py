"""The pair admission rule of kernels 5 / 6, the resident and streaming
cluster walks (optix_raytracer_tpu_torch.accel.clusters.admitted_pairs_plain),
on the CPU: the plain walks restricted to the admitted pairs
(walk_closest_plain / walk_any_plain with admitted=True, the kernels' work)
must give the rows and occlusion of the unchanged plain walks bit for bit,
ungated and gated, on random, grazing and lone rays and on exact ties, and
each term of the rule is shown needed (the gate, the margin).

The plain walks are held against the JAX package's Pallas kernels by
test_torch_clusters.py; these tests hold the rule to the plain walks. Small
knots: knot_scene(20, 14) (562 triangles, 5 clusters) and knot_scene(90, 50)
(9,002 triangles, 71 clusters), both at the resident tier; torch on one
thread.
"""
import numpy as np
import pytest
import torch

from optix_raytracer_tpu_torch.accel import clusters as tcl
from optix_raytracer_tpu_torch.scene import builtins as tbuiltins

from test_torch_clusters import ray_set, trays
import torch_parity
from torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def knots():
    return {"small": tbuiltins.knot_scene(20, 14, device="cpu"),
            "9k": tbuiltins.knot_scene(90, 50, device="cpu")}


def _arrs(rays8):
    """[N, 8] rays → ray_set's (o, d, tmin, tmax)."""
    return (rays8[:, 0:3].copy(), rays8[:, 3:6].copy(), rays8[:, 6].copy(),
            rays8[:, 7].copy())


def _walk_args(cl, arrs, exact, gate):
    packed = tcl._pack_rays(trays(arrs), tcl._padded(arrs[0].shape[0]))
    counts, lists, tnear = tcl._cull(cl, packed, packed.shape[0] // tcl.SUPER,
                                     cl.c_pad, exact=exact)
    assert int(counts.max()) > 0
    return counts, lists, tnear, cl.comp, cl.aabb, packed, gate


def _admitted_vs_plain(cl, arrs, exact, gate):
    """Both walks of one ray set → (rows, occ) of the plain walks, after
    holding the admitted walks to them bit for bit."""
    args = _walk_args(cl, arrs, exact, gate)
    rows = tcl.walk_closest_plain(*args)
    rows_a = tcl.walk_closest_plain(*args, admitted=True)
    np.testing.assert_array_equal(rows_a.view(torch.int32).numpy(),
                                  rows.view(torch.int32).numpy())
    occ = tcl.walk_any_plain(*args)
    np.testing.assert_array_equal(
        tcl.walk_any_plain(*args, admitted=True).numpy(), occ.numpy())
    return rows, occ


def _hits_some(rows, occ):
    hit = rows[:, 6] >= 0
    assert hit.any() and occ.any()


@pytest.mark.parametrize("knot", ["small", "9k"])
@pytest.mark.parametrize("exact,gate", [(False, False), (True, False),
                                        (True, True)])
def test_admitted_walks_match_plain(knots, knot, exact, gate):
    """Random rays toward the knot, some dead, mixed windows: the interval
    cull (ungated) and the exact cull, ungated and gated."""
    rows, occ = _admitted_vs_plain(knots[knot].clusters,
                                   ray_set(n=1536, seed=51), exact, gate)
    _hits_some(rows, occ)


@pytest.mark.parametrize("exact,gate", [(False, False), (True, False),
                                        (True, True)])
def test_admitted_walks_match_on_grazing_rays(knots, exact, gate):
    """Rays in the planes of cluster box faces (+-0 direction components),
    through corners and edges, at the vertices that set a face, along a
    face, and windows that end on one (torch_parity.sc_grazing_rays on the
    71 cluster boxes)."""
    scene = knots["9k"]
    cl = scene.clusters
    rays8 = torch_parity.sc_grazing_rays(scene.geom, cl,
                                         tcl._entry_boxes(cl.aabb), seed=3)
    assert (rays8[:, 3:6] == 0).any() and len(rays8) >= 380
    rows, occ = _admitted_vs_plain(cl, _arrs(rays8), exact, gate)
    _hits_some(rows, occ)


def test_admitted_walks_at_the_streaming_tier(knots, monkeypatch):
    """Past MAX_CLUSTERS the query takes the interval cull and an ungated
    walk, whatever it asks for (the streaming tier's dispatch); the
    admitted walks agree there too, through the queries."""
    cl = knots["small"].clusters
    arrs = ray_set(n=1024, seed=52)
    monkeypatch.setattr(tcl, "MAX_CLUSTERS", 2)
    walked = []
    plain = tcl.walk_closest_plain

    def spy(*args, **kw):
        walked.append(args[-1])
        return plain(*args, **kw)
    monkeypatch.setattr(tcl, "walk_closest_plain", spy)
    hits = tcl.closest_hit(cl, trays(arrs), exact=True, group_walk=True)
    assert walked == [False]
    monkeypatch.setattr(tcl, "walk_closest_plain", plain)
    args = _walk_args(cl, arrs, True, False)
    assert ((args[1] >> 16) == 0xFF).all()      # no gate bits: interval cull
    rows, occ = _admitted_vs_plain(cl, arrs, True, False)
    np.testing.assert_array_equal(hits.prim_id.numpy(),
                                  rows[:len(arrs[0]), 6].numpy())
    _hits_some(rows, occ)


def test_admitted_walks_keep_the_tie_rule():
    """Exact ties at t = 1 (torch_parity.sc_tie_case at the resident tier:
    six clusters, each triangle placed twice): the lower slot wins over the
    earlier list entry, in one cluster and across clusters, and at an equal
    slot the earlier entry; the admitted walks agree bit for bit."""
    geom, tri_mat, order, rays8, expect = torch_parity.sc_tie_case()
    cl = tcl.build_clusters(geom, tri_mat, order=order)
    assert cl.num_clusters == 6 and cl.comp.shape[0] == 6
    n = len(rays8)
    for exact, gate in ((False, False), (True, False), (True, True)):
        rows, _ = _admitted_vs_plain(cl, _arrs(rays8), exact, gate)
        prim = rows[:n, 6].numpy().astype(np.int64)
        assert (prim >= 0).all() and (rows[:n, 0].numpy() == 1.0).all()
        # B and C: the lower slot wins, whatever the list order
        for k in (1, 2):
            check = slice(9 * k, 9 * k + 3)
            np.testing.assert_array_equal(prim[check], expect[check])
        # A and D: one slot in two clusters, the earlier entry wins
        for k, pair in ((0, (0, 1)), (3, (6, 7))):
            assert set(prim[9 * k:9 * k + 9]) <= set(pair)


def test_gate_term_is_needed(knots, monkeypatch):
    """A grazing ray alone in its 32-ray group, whose accepted hit lies in a
    cluster that only another group's ray crosses
    (torch_parity.lone_gated_rays): the gated plain walk never tests that
    pair, so neither may the rule. The admitted walks equal the gated plain
    walks; the rule without its gate term gives other rows and occlusion."""
    scene = knots["9k"]
    cl = scene.clusters
    rays8 = torch_parity.lone_gated_rays(scene.geom, cl)
    assert len(rays8) >= 10 * 256
    rows, occ = _admitted_vs_plain(cl, _arrs(rays8), True, True)
    args = _walk_args(cl, _arrs(rays8), True, True)
    rule = tcl.admitted_pairs_plain

    def no_gate(a, boxes, gm, gate, best_t=None):
        return rule(a, boxes, gm, False, best_t)
    monkeypatch.setattr(tcl, "admitted_pairs_plain", no_gate)
    wide = tcl.walk_closest_plain(*args, admitted=True)
    wide_occ = tcl.walk_any_plain(*args, admitted=True)
    monkeypatch.setattr(tcl, "admitted_pairs_plain", rule)
    assert not torch.equal(wide, rows) and not torch.equal(wide_occ, occ)
    # without the gate the rule is the ungated walk's
    ungated, ungated_occ = _admitted_vs_plain(cl, _arrs(rays8), True, False)
    assert torch.equal(wide, ungated) and torch.equal(wide_occ, ungated_occ)


def test_margin_is_needed(knots, monkeypatch):
    """On the grazing rays of the 71 cluster boxes, some (ray, cluster) pair
    whose Woop test accepts a hit lies outside the ray's unwidened slab
    test: with the margin at 0 the rule would drop it, with the stated
    margin it drops none."""
    scene = knots["9k"]
    cl = scene.clusters
    boxes = tcl._entry_boxes(cl.aabb)[:cl.num_clusters]
    a = torch.as_tensor(np.concatenate([
        torch_parity.sc_grazing_rays(scene.geom, cl, boxes, seed=s,
                                     boxes=71) for s in range(4)]))[None]
    n_c = cl.num_clusters
    accepted = torch.stack([
        tcl._pair_ok(cl.comp[c:c + 1], a, None, False)[0].any(dim=2)[0]
        for c in range(n_c)], dim=1)                        # [N, C]
    dropped = {}
    for margin in ("stated", "zero"):
        if margin == "zero":
            monkeypatch.setattr(tcl, "SC_MARGIN_REL", 0.0)
            monkeypatch.setattr(tcl, "SC_MARGIN_FLOOR", 0.0)
        adm = tcl.admitted_pairs_plain(a.expand(n_c, -1, -1), boxes, None,
                                       False, a[0, :, 7].expand(n_c, -1))
        dropped[margin] = int((accepted & ~adm.T).sum())
    assert dropped == {"stated": 0, "zero": dropped["zero"]}
    assert dropped["zero"] > 0
