"""The port's cluster-major queue traversal (optix_raytracer_tpu_torch.accel.
qwalk: the octet cull, the work list, the marshalled rays, the plain versions
of kernels 7-8 and the queries) against the JAX package's accel/qwalk.py on
the CPU, its Pallas kernels in interpret mode, on the small knot
(knot_scene(20, 14): 562 triangles, 5 clusters).

The reference runs with one 256-ray block per grid step (GROUPS = 1, SUPER =
256), patched in its clusters module and in qwalk, which binds both at
import (test_torch_clusters.py says why). The port keeps its own 16-block
padding except where a test patches it too: the work list's capacity
k_cap = 6 * n_padded / 8 depends on the padding, so k_cap and the overflow
flag are compared only with equal padding; n_items never depends on it.

Bars: octet masks, work lists, marshalled rays and step tables bit-equal;
hit and material ids and occlusion equal; t within rtol 1e-5, uv atol 1e-4,
normals atol 1e-5 (tests/test_pallas_intersect.py); renders with equal ray
counts and radiance within atol 2e-3 / rtol 1e-3.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_raytracer_tpu.accel import clusters as jcl
from optix_raytracer_tpu.accel import qwalk as jqwalk
from optix_raytracer_tpu.core import film as jfilm
from optix_raytracer_tpu.scene import builtins as jbuiltins
from optix_raytracer_tpu.wavefront import engine as jengine
from optix_raytracer_tpu.wavefront import intersect as jintersect
from optix_raytracer_tpu_torch import kernels
from optix_raytracer_tpu_torch.accel import bruteforce as tbf
from optix_raytracer_tpu_torch.accel import clusters as tcl
from optix_raytracer_tpu_torch.accel import qwalk as tqwalk
from optix_raytracer_tpu_torch.core.film import Film
from optix_raytracer_tpu_torch.scene import builtins as tbuiltins
from optix_raytracer_tpu_torch.wavefront import engine
from optix_raytracer_tpu_torch.wavefront import intersect as tintersect

from test_torch_clusters import assert_hits_match, jrays, ray_set, trays
import torch_parity
from torch_parity import (jax_native_sah, one_torch_thread,  # noqa: F401
                         torch_cam, torch_scene)

# The JAX knots here are built through the reference's SAH library, which
# builds itself in place; the fixture builds it first, atomically, under a
# lock (torch_parity.jax_native_sah).
pytestmark = pytest.mark.usefixtures("jax_native_sah")

ATOL, RTOL = 2e-3, 1e-3
W = H = 16


@pytest.fixture(scope="module", autouse=True)
def one_block_per_step():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jcl, jqwalk):
            mp.setattr(mod, "GROUPS", 1)
            mp.setattr(mod, "SUPER", jcl.SUB)
        jax.clear_caches()
        yield
    jax.clear_caches()


@pytest.fixture
def port_one_block(monkeypatch):
    """The port padded like the patched reference (256-ray units)."""
    monkeypatch.setattr(tcl, "GROUPS", 1)
    monkeypatch.setattr(tcl, "SUPER", tcl.SUB)


@pytest.fixture(scope="module")
def knot():
    js = jbuiltins.knot_scene(20, 14)     # 562 triangles, 5 clusters
    return js, torch_scene(js)


def _queue_inputs(js, ts, arrs, qf=6):
    """Both packages' (packed, om, build_queue output) on the same rays,
    padded to 4096 rows on both sides."""
    tr = trays(arrs)
    n, n_padded, packed, n_blocks, c_pad, k_cap = tqwalk._prep(
        ts.clusters, tr, qf)
    jpacked = jnp.asarray(packed.numpy())
    om = tqwalk._oct_cull(ts.clusters, packed, n_blocks, c_pad)
    jom = jqwalk._oct_cull(js.clusters, jpacked, n_blocks, c_pad,
                           interpret=True)
    return packed, jpacked, om, jom, n_padded, k_cap


def test_constants_and_prep_read_padding_at_call_time(knot, monkeypatch):
    js, ts = knot
    assert (tqwalk.OCT, tqwalk.ITEMS, tqwalk.ROWS) == (
        jqwalk.OCT, jqwalk.ITEMS, jqwalk.ROWS)
    arrs = ray_set(n=3000)
    own = tqwalk._prep(ts.clusters, trays(arrs), 6)
    assert own[1] == 4096 and own[5] == 3072          # 16-block padding
    monkeypatch.setattr(tcl, "SUPER", tcl.SUB)
    own = tqwalk._prep(ts.clusters, trays(arrs), 6)
    ref = jqwalk._prep(js.clusters, jrays(arrs), 6)
    for i in (0, 1, 3, 4, 5):
        assert own[i] == int(ref[i])
    np.testing.assert_array_equal(own[2].numpy(), np.asarray(ref[2]))


def test_oct_cull_plain_matches_pallas(knot):
    """Kernel 7's plain version vs _oct_cull_kernel (interpret): bit-equal
    [n_blocks, c_pad] masks, bit 31 included; a dead block is all zero;
    padding clusters cross every live ray, as in the reference."""
    js, ts = knot
    _, _, om, jom, _, _ = _queue_inputs(js, ts, ray_set())
    om = om.numpy()
    np.testing.assert_array_equal(om, np.asarray(jom))
    assert om.shape == (16, 128)
    assert (om[2] == 0).all()                       # rays 512-767 dead
    assert (om[:, 5:] != 0).any() and (om[:, :5] != 0).any()
    assert (om < 0).any()                           # bit 31 (octet 31) set


def test_oct_bits_fold_to_group_bits(knot):
    """Four octet bits OR to the exact cull's 32-ray group bit."""
    _, ts = knot
    packed = tcl._pack_rays(trays(ray_set(seed=5)), 4096)
    c_pad = ts.clusters.c_pad
    om = tqwalk.oct_cull_plain(ts.clusters.aabb, packed, 16, c_pad)
    _, gm = tcl.exact_cull_plain(ts.clusters.aabb, packed, 16, c_pad)
    u = om.to(torch.int64) & 0xFFFFFFFF
    fold = sum((((u >> (4 * g)) & 0xF) != 0).to(torch.int64) << g
               for g in range(8))
    np.testing.assert_array_equal(fold.numpy(), gm.numpy())


@pytest.mark.parametrize("qf", [6, 1])
def test_build_queue_and_marshal_match_jax(knot, qf):
    """Steps, work list, n_items and overflow (equal padding: 4096 rays) and
    the marshalled rays and row ids, bit-equal; qf = 1 overflows."""
    js, ts = knot
    packed, jpacked, om, jom, n_padded, k_cap = _queue_inputs(
        js, ts, ray_set(), qf)
    steps, work, overflow, n_items = tqwalk._build_queue(
        om, ts.clusters.num_clusters, n_padded, k_cap)
    jsteps, jwork, joverflow, jn_items = jqwalk._build_queue(
        jom, js.clusters.num_clusters, n_padded, k_cap)
    np.testing.assert_array_equal(steps.numpy(), np.asarray(jsteps))
    np.testing.assert_array_equal(work.numpy(), np.asarray(jwork))
    assert n_items == int(jn_items) and overflow == bool(joverflow)
    assert overflow == (qf == 1) and n_items % tqwalk.ITEMS == 0
    q, qrow = tqwalk._marshal(packed, work, n_padded)
    jq, jqrow = jqwalk._marshal(jpacked, jwork, n_padded)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(qrow.numpy(), np.asarray(jqrow))


@pytest.mark.parametrize("seed", [0, 1])
def test_build_queue_random_masks_match_jax(seed):
    """Random octet masks (every bit, 40 clusters, some empty), unequal
    run lengths and a capacity that cuts the list: bit-equal to the
    reference's pure-XLA build."""
    rng = np.random.default_rng(seed)
    om = rng.integers(-2 ** 31, 2 ** 31, (48, 128), dtype=np.int64)
    om = np.where(rng.random((48, 128)) < 0.3, om, 0).astype(np.int32)
    om[:, 7] = 0
    for k_cap in (32 * 700, 32 * 200):
        own = tqwalk._build_queue(torch.as_tensor(om), 40, 48 * 256, k_cap)
        ref = jqwalk._build_queue(jnp.asarray(om), 40, 48 * 256, k_cap)
        for a, b in zip(own[:2], ref[:2]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert own[3] == int(ref[3]) and own[2] == bool(ref[2])
    assert own[2]                                 # the smaller cap overflows


@pytest.mark.parametrize("closest", [True, False])
def test_queue_candidates_match_pallas(knot, closest):
    """Kernel 8's plain version vs _run_queue (interpret) on the live steps:
    ids and flags equal, t / uv / normals within the bars."""
    js, ts = knot
    packed, _, om, _, n_padded, k_cap = _queue_inputs(js, ts, ray_set())
    steps, work, _, n_items = tqwalk._build_queue(
        om, ts.clusters.num_clusters, n_padded, k_cap)
    q, _ = tqwalk._marshal(packed, work, n_padded)
    live = n_items * tqwalk.OCT
    own = tqwalk._run_queue(closest, ts.clusters.comp, steps, q)[:, :live]
    kernel = jqwalk._q_closest_kernel if closest else jqwalk._q_any_kernel
    ref = np.asarray(jqwalk._run_queue(
        kernel, 8 if closest else 1, js.clusters, jnp.asarray(steps.numpy()),
        jnp.asarray(q.numpy()), True))[:, :live]
    own = own.numpy()
    if not closest:
        np.testing.assert_array_equal(own, ref)
        assert 0 < own.sum() < live
        return
    np.testing.assert_array_equal(own[6:], ref[6:])
    hit = own[6] >= 0
    assert hit.any() and (~hit).any()
    np.testing.assert_allclose(own[0], ref[0], rtol=1e-5)
    np.testing.assert_allclose(own[1:3], ref[1:3], atol=1e-4)
    # A candidate's normal is unnormalised n0 + u*d10 + v*d20, so the uv
    # difference the bar above allows (XLA fuses the multiply-adds of u, v
    # on the CPU) moves it by up to |d10|*|du| + |d20|*|dv|: atol 1e-5 on
    # top of that, per candidate.
    d = np.abs(ts.clusters.comp.numpy()[:, 21:27]).max()
    duv = np.abs(own[1:3] - ref[1:3]).sum(axis=0)
    assert (np.abs(own[3:6] - ref[3:6]) <= 1e-5 + d * duv).all()


@pytest.fixture(scope="module")
def knot9k():
    return tbuiltins.knot_scene(90, 50, device="cpu")   # 71 clusters


def _arrs(rays8):
    """[N, 8] rays → ray_set's (o, d, tmin, tmax)."""
    return (rays8[:, 0:3].copy(), rays8[:, 3:6].copy(), rays8[:, 6].copy(),
            rays8[:, 7].copy())


def _admission_rays(case, knot, knot9k):
    """(table, ray_set-style arrays) of one admission case."""
    small, big = knot[1].clusters, knot9k.clusters
    if case == "knot_random":
        return small, ray_set()
    if case == "knot9k_random":
        return big, ray_set(seed=5)
    if case.startswith("edge"):
        return small, _arrs(torch_parity.cull_edge_rays(
            small.aabb.numpy(), int(case[-1])))
    if case == "lone":
        return big, _arrs(torch_parity.lone_gated_rays(knot9k.geom, big))
    if case == "grazing":
        boxes = tcl._entry_boxes(big.aabb)[:big.num_clusters]
        return big, _arrs(np.concatenate([torch_parity.sc_grazing_rays(
            knot9k.geom, big, boxes, seed=s, boxes=71) for s in (0, 1)]))
    if case == "all_miss":
        return small, _arrs(torch_parity.queue_miss_rays(small))
    if case == "tie":
        geom, tri_mat, order, rays8, _ = torch_parity.sc_tie_case()
        return tcl.build_clusters(geom, tri_mat, order=order), _arrs(rays8)
    o, d, tmin, tmax = ray_set(seed=11)                 # "padding"
    tmax = np.where(np.arange(tmax.size) % 401 == 0, 1e16, 0.0)
    return small, (o, d, tmin, tmax.astype(np.float32))


@pytest.mark.parametrize("case", ["knot_random", "knot9k_random", "edge0",
                                  "edge1", "lone", "grazing", "all_miss",
                                  "tie", "padding"])
def test_queue_admission_rule(knot, knot9k, case):
    """Kernel 8's admission rule (queue_admitted_plain) on a query's whole
    work list: random rays on both knots, the cull's edge-case rays
    (torch_parity.cull_edge_rays), grazing rays (sc_grazing_rays on the
    9k knot's cluster boxes), rays alone in their octet
    (lone_gated_rays), steps whose admitted rays all miss
    (queue_miss_rays), exact ties (sc_tie_case at the resident tier: two
    copies of a triangle in one cluster) and a list of mostly padding
    items. Every column
    left out holds the plain versions' miss row (t = tmax, zeros, ids -1)
    and flag 0.0, bit for bit, so the kernel's rule applied to the plain
    candidates gives them back whole; the admitted rays hold every ray
    whose own slab test crosses the unwidened box (needed) and are live.
    On the edge, grazing and tie sets (the tie set's rays through the flat
    triangles' corners and edges) some hit lies outside the unwidened box:
    the margin is needed."""
    cl, arrs = _admission_rays(case, knot, knot9k)
    tr = trays(arrs)
    n, n_padded, packed, n_blocks, c_pad, _ = tqwalk._prep(cl, tr, 6)
    om = tqwalk._oct_cull(cl, packed, n_blocks, c_pad)
    steps, work, overflow, n_items = tqwalk._build_queue(
        om, cl.num_clusters, n_padded, 1 << 20)
    assert not overflow and n_items > 0
    qrays, _ = tqwalk._marshal(packed, work[:n_items], n_padded)
    steps = steps[:, :n_items // tqwalk.ITEMS].contiguous()
    adm = tqwalk.queue_admitted_plain(steps, qrays, cl.aabb)
    cand = tqwalk.queue_closest_plain(steps, qrays, cl.comp)
    occ = tqwalk.queue_any_plain(steps, qrays, cl.comp)[0]
    miss = torch.zeros_like(cand)
    miss[0], miss[6:] = qrays[7], -1.0
    kernel_rule = torch.where(adm[None], cand, miss)
    assert torch.equal(kernel_rule.view(torch.int32), cand.view(torch.int32))
    assert torch.equal(torch.where(adm, occ, 0.0), occ)
    needed = torch.zeros_like(adm)
    boxes = tcl._entry_boxes(cl.aabb)
    for c, o, rays in tqwalk._step_chunks(steps, qrays, 256):
        cross = tcl._slab_cross(rays, boxes[c][:, 0:3], boxes[c][:, 3:6])[0]
        tqwalk._scatter_cols(needed[None], o, cross.reshape(-1, 1))
    live = qrays[7] > qrays[6]
    assert not (needed & ~adm).any() and not (adm & ~live).any()
    assert int(needed.sum()) <= int(adm.sum()) <= adm.numel()
    hit = cand[6] >= 0
    assert torch.equal(hit, occ > 0) and hit.any() == (case != "all_miss")
    if case == "all_miss":
        assert int(adm.sum()) >= 8 * tqwalk.ROWS
    assert (hit & ~needed).any() == (case in ("edge0", "edge1", "grazing",
                                              "tie"))
    if case == "padding":
        assert int((work[:n_items] < 0).sum()) > 0.75 * n_items
        assert int(adm.sum()) < 0.1 * adm.numel()


@pytest.mark.parametrize("n,seed", [(4096, 3), (3000, 8)])
def test_queries_match_jax_walk_and_bruteforce(knot, n, seed):
    """closest_hit / any_hit vs the reference's queue (interpret), the
    port's gated walk and brute force (ids, t), with the port's own padding
    (equal to the reference's at 4096 rays, not at 3000)."""
    js, ts = knot
    arrs = ray_set(n=n, seed=seed)
    jr, tr = jrays(arrs), trays(arrs)
    tqwalk.reset_stats()
    own = tqwalk.closest_hit(ts.clusters, tr)
    assert_hits_match(own, jqwalk.closest_hit(js.clusters, jr,
                                              interpret=True))
    walk = tcl.closest_hit(ts.clusters, tr, exact=True, group_walk=True)
    for f in ("prim_id", "mat_id", "t", "uv"):
        np.testing.assert_array_equal(getattr(own, f).numpy(),
                                      getattr(walk, f).numpy())
    np.testing.assert_allclose(own.normal.numpy(), walk.normal.numpy(),
                               atol=1e-6)
    brute = tbf.intersect_closest(ts.geom, tr, tri_mat=ts.tri_mat)
    np.testing.assert_array_equal(own.prim_id.numpy(), brute.prim_id.numpy())
    np.testing.assert_allclose(own.t.numpy(), brute.t.numpy(), rtol=1e-5)
    occ = tqwalk.any_hit(ts.clusters, tr)
    np.testing.assert_array_equal(
        occ.numpy(), np.asarray(jqwalk.any_hit(js.clusters, jr,
                                               interpret=True)))
    np.testing.assert_array_equal(
        occ.numpy(), tcl.any_hit(ts.clusters, tr, exact=True).numpy())
    np.testing.assert_array_equal(occ.numpy(),
                                  tbf.intersect_any(ts.geom, tr).numpy())
    assert occ.any() and not occ.all()
    assert tqwalk.STATS == {"closest_queue": 1, "closest_overflow": 0,
                            "any_queue": 1, "any_overflow": 0}


def test_overflow_falls_back_to_the_walk(knot, monkeypatch, port_one_block):
    """qf = 1: both packages overflow (equal padding) and answer with the
    exact-cull walk; queue_stats equal; the queue kernel is not run."""
    js, ts = knot
    arrs = ray_set(n=2048, seed=9)
    jr, tr = jrays(arrs), trays(arrs)
    own = tqwalk.queue_stats(ts.clusters, tr, qf=1)
    ref = jqwalk.queue_stats(js.clusters, jr, qf=1, interpret=True)
    assert own == pytest.approx(ref, rel=1e-12) and own["overflow"]
    assert tqwalk.queue_stats(ts.clusters, tr) == pytest.approx(
        jqwalk.queue_stats(js.clusters, jr, interpret=True), rel=1e-12)
    ran = []
    monkeypatch.setattr(tqwalk, "_run_queue",
                        lambda *a: ran.append(a) or None)
    tqwalk.reset_stats()
    assert_hits_match(tqwalk.closest_hit(ts.clusters, tr, qf=1),
                      jqwalk.closest_hit(js.clusters, jr, interpret=True,
                                         qf=1))
    np.testing.assert_array_equal(
        tqwalk.any_hit(ts.clusters, tr, qf=1).numpy(),
        np.asarray(jqwalk.any_hit(js.clusters, jr, interpret=True, qf=1)))
    assert not ran
    assert tqwalk.STATS == {"closest_queue": 0, "closest_overflow": 1,
                            "any_queue": 0, "any_overflow": 1}


@pytest.mark.parametrize("qwalk_on", [True, False])
def test_dispatch_follows_ort_qwalk(knot, monkeypatch, qwalk_on):
    """ORT_QWALK=1 routes exact closest-hit and every any-hit query of a
    cluster scene through the queue; bounce-0 (interval-cull) closest hits
    and ORT_QWALK=0 keep the walk."""
    _, ts = knot
    monkeypatch.setenv("ORT_QWALK", "1" if qwalk_on else "0")
    calls = []
    for mod, names in ((tqwalk, ("closest_hit", "any_hit")),
                       (tcl, ("closest_hit", "any_hit"))):
        for name in names:
            fn = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=(
                mod.__name__.rsplit(".", 1)[1], name), **k: (
                    calls.append(_n), _f(*a, **k))[1])
    tr = trays(ray_set(n=1000)).reshape(10, 100)
    hits = tintersect.scene_closest(ts, tr, exact=True)
    assert hits.prim_id.shape == (10, 100)
    tintersect.scene_closest(ts, tr, exact=False)
    occ = tintersect.scene_any(ts, tr)
    assert occ.shape == (10, 100)
    queue = ("qwalk", "closest_hit"), ("qwalk", "any_hit")
    if qwalk_on:
        assert calls == [queue[0], ("clusters", "closest_hit"), queue[1]]
    else:
        assert calls == [("clusters", "closest_hit")] * 2 + [
            ("clusters", "any_hit")]


@pytest.fixture
def jax_qwalk_path(monkeypatch):
    """The JAX engine on its cluster path (test_torch_knot_engine.py) with
    ORT_QWALK=1 on both sides; the reference's queries in interpret mode."""
    monkeypatch.setenv("ORT_QWALK", "1")
    monkeypatch.setattr(jintersect, "_use_clusters",
                        lambda scene: scene.has_clusters)
    for mod, names in ((jcl, ("closest_hit", "any_hit")),
                       (jqwalk, ("closest_hit", "any_hit"))):
        for name in names:
            monkeypatch.setattr(mod, name, functools.partial(
                getattr(mod, name), interpret=True))
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("impl,jimpl", [("auto", "auto"),
                                        ("wavefront", "xla")])
def test_render_through_queue_matches_jax(knot, jax_qwalk_path, impl, jimpl):
    """16², spl 8, depth 2, one launch under ORT_QWALK=1: the sample-major
    path ("auto") and the sequential sorted path ("wavefront" / "xla"),
    both with their bounce-1 closest hits and all NEE queries through the
    queue."""
    js, ts = knot
    jcam = jbuiltins.knot_camera(W, H).params()
    jf, jr = jengine.render_accumulate(
        js, jcam, jfilm.Film.create(H, W), W, H, samples_per_launch=8,
        max_depth=2, chunk_size=None, impl=jimpl)
    tqwalk.reset_stats()
    tf, tr = engine.render_accumulate(
        ts, torch_cam(jcam), Film.create(H, W, "cpu"), W, H,
        samples_per_launch=8, max_depth=2, impl=impl)
    n_queries = 2 if impl == "auto" else 16
    assert _stats_total() == (n_queries // 2, n_queries)
    assert int(tr) == int(float(jr)) > W * H * 8
    np.testing.assert_allclose(tf.accum.numpy(), np.asarray(jf.accum),
                               atol=ATOL, rtol=RTOL)
    assert float(tf.accum.mean()) > 0


def _stats_total():
    """(closest, any-hit) queries the queue module answered or handed to the
    walk."""
    s = tqwalk.STATS
    return (s["closest_queue"] + s["closest_overflow"],
            s["any_queue"] + s["any_overflow"])


def test_wrappers_need_cuda_or_cpu(knot):
    _, ts = knot
    meta = torch.device("meta")
    packed = torch.zeros((4096, 8), device=meta)
    cl = tcl.ClusterSet(comp=ts.clusters.comp.to(meta),
                        aabb=ts.clusters.aabb.to(meta),
                        slot_prim=ts.clusters.slot_prim.to(meta),
                        num_clusters=5)
    with pytest.raises(ValueError, match="unsupported device"):
        tqwalk._oct_cull(cl, packed, 16, 128)
    steps = torch.zeros((3, 4), dtype=torch.int32, device=meta)
    for closest in (True, False):
        with pytest.raises(ValueError, match="unsupported device"):
            tqwalk._run_queue(closest, cl.comp, steps,
                              torch.zeros((8, 1024), device=meta))
    assert {"qwalk_oct_cull", "qwalk_closest", "qwalk_any"} <= set(
        kernels.LAUNCHES)
