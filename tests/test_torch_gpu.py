"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked `gpu`; every test skips when `torch.cuda.is_available()` is false
(decided in a fixture, never at import). Run on a CUDA machine with
`python -m pytest tests/test_torch_gpu.py -m gpu`. Bars: hit ids and
occlusion equal, t within rtol 1e-5, uv 1e-4, normals 1e-5
(test_pallas_intersect.py); the exact cull's tables bit-equal; ray counts
equal and radiance within atol 2e-3 / rtol 1e-3 (test_fused_kernel.py)."""
import dataclasses
import types

import numpy as np
import pytest
import torch

from optix_raytracer_tpu_torch import kernels, telemetry
from optix_raytracer_tpu_torch.accel import clusters as C
from optix_raytracer_tpu_torch.accel import pallas_bf, tlas
from optix_raytracer_tpu_torch.accel.geometry import build_triangle_geometry
from optix_raytracer_tpu_torch.accel.tri_groups import (bf_group_boxes,
                                                        fused_group_boxes)
from optix_raytracer_tpu_torch.core.film import Film
from optix_raytracer_tpu_torch.core.rays import Rays
from optix_raytracer_tpu_torch.scene import builtins as B
from optix_raytracer_tpu_torch.scene.builtins import (cornell_box,
                                                     cornell_camera,
                                                     knot_camera, knot_scene)
from optix_raytracer_tpu_torch.wavefront import engine, pallas_pt

import torch_parity

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _mesh_and_rays(num_tris, n_rays, seed, device):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (num_tris, 3))
    verts = np.concatenate([v0, v0 + rng.uniform(-1, 1, (num_tris, 3)),
                            v0 + rng.uniform(-1, 1, (num_tris, 3))])
    idx = np.arange(3 * num_tris).reshape(3, num_tris).T.copy()
    idx[num_tris // 2, 2] = idx[num_tris // 2, 1]   # one degenerate triangle
    geom = build_triangle_geometry(verts.astype(np.float32),
                                   idx.astype(np.int32), device)
    tri_mat = torch.as_tensor(rng.integers(0, 5, num_tris).astype(np.int32),
                              device=device)
    o = rng.uniform(-3, 3, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays.make(torch.as_tensor(o, device=device),
                     torch.as_tensor(d, device=device), tmin=1e-3, tmax=50.0)
    return geom, tri_mat, rays


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_bf_equal(geom, tri_mat, rays, boxes):
    """Kernels 1-2 against their plain versions on the card, bit for bit
    (ids, t, uv, normals, occlusion), culling by `boxes` (bf_group_boxes)
    or not; each wrapper counts one launch."""
    tri = geom.tri_consts
    before = dict(kernels.LAUNCHES)
    out = pallas_bf.closest_hit(tri, tri_mat, rays, boxes=boxes)
    occ = pallas_bf.any_hit(tri, rays, boxes=boxes)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bf_closest"] == before["bf_closest"] + 1
    assert kernels.LAUNCHES["bf_any"] == before["bf_any"] + 1
    ref = pallas_bf.closest_hit_plain(tri, tri_mat, rays)
    for k in ("t", "prim_id", "mat_id", "uv", "normal"):
        assert torch.equal(_bits(out[k]), _bits(ref[k])), k
    assert torch.equal(occ, pallas_bf.any_hit_plain(tri, rays))
    return ref, occ


# m across the group cutoff (10), the Cornell box's 32 and past 512
BF_TRIS = [1, 9, 10, 31, 32, 33, 40, 257, 482, 700]


@pytest.mark.parametrize("num_tris", BF_TRIS)
def test_bf_kernels_match_plain(cuda, num_tris):
    """Random meshes, 1537 rays (not a multiple of any block), all live
    and half dead, with the table's group boxes and without."""
    geom, tri_mat = torch_parity.bf_mesh(num_tris, num_tris, device=cuda)
    boxes = bf_group_boxes(geom)
    for dead in (0.0, 0.5):
        rays = torch_parity.bf_rays(1537, 7 + num_tris, dead=dead, geom=geom,
                                    device=cuda)
        for b in ((None,) if boxes is None else (boxes, None)):
            ref, occ = _assert_bf_equal(geom, tri_mat, rays, b)
            assert (ref["prim_id"] >= 0).any() and occ.any()


@pytest.mark.parametrize("m", [16, 40, 64, 100])
def test_bf_kernels_ties(cuda, m):
    """Duplicated triangles, each pair ceil(m / 2) rows apart and so in
    different groups, rays at their centroids and vertices: the lowest id
    wins, as the plain version's argmin."""
    geom, tri_mat = torch_parity.bf_mesh(m, 5, dup=True, device=cuda)
    ref, _ = _assert_bf_equal(geom, tri_mat,
                              torch_parity.tie_rays(geom, device=cuda),
                              bf_group_boxes(geom))
    pid = ref["prim_id"]
    assert (pid >= 0).sum() > 3 * m // 4
    assert (pid[pid >= 0] < -(-m // 2)).all()


@pytest.mark.parametrize("m", [32, 482])
def test_bf_kernels_edge_rays(cuda, m):
    """torch_parity.cull_edge_rays on the group boxes, and the walks' lone
    grazing rays on knot_scene(20, 14)'s 562 triangles."""
    geom, tri_mat = torch_parity.bf_mesh(m, m + 1, device=cuda)
    boxes = bf_group_boxes(geom)
    r8 = torch_parity.cull_edge_rays(torch_parity.group_box_table(boxes),
                                     seed=m, n=2048)
    _assert_bf_equal(geom, tri_mat, torch_parity.rays8(r8, cuda), boxes)
    scene = knot_scene(20, 14, device=cuda)
    r8 = torch_parity.lone_gated_rays(scene.geom, scene.clusters,
                                      seeds=range(2))
    ref, _ = _assert_bf_equal(scene.geom, scene.tri_mat,
                              torch_parity.rays8(r8, cuda),
                              bf_group_boxes(scene.geom))
    assert (ref["prim_id"] >= 0).sum() > 2


def test_bf_kernels_instance_slices(cuda):
    """The instanced Cornell box's slices of the shared table, rays in each
    instance's object space, with the slice's own boxes
    (DeviceScene.bf_boxes) and without; and the instance loop through the
    scene against the CPU's."""
    scene = B.cornell_box_instanced(cuda)
    rng = np.random.default_rng(3)
    o = rng.uniform([50, 50, -300], [500, 500, -100], (3000, 3))
    d = rng.uniform([0, 0, 0], [556, 548, 559], (3000, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r8 = np.concatenate([o, d, np.full((3000, 1), 1e-2),
                         rng.choice([1e16, 0.0], (3000, 1))], axis=1)
    rays = torch_parity.rays8(r8, cuda)
    ranges = tlas.instance_ranges(scene.instances, scene.num_triangles)
    for i, (lo, hi) in enumerate(ranges):
        sub = tlas.slice_geometry(scene.geom, lo, hi)
        obj = tlas._object_rays(scene.instances.inv_transform[i], rays,
                                rays.tmax)
        assert scene.bf_boxes[i] is not None
        for boxes in (scene.bf_boxes[i], None):
            _assert_bf_equal(sub, scene.tri_mat[lo:hi], obj, boxes)
    hits = tlas.intersect_instances(scene.geom, scene.instances, rays,
                                    tri_mat=scene.tri_mat,
                                    boxes=scene.bf_boxes)
    cpu = B.cornell_box_instanced("cpu")
    ref = tlas.intersect_instances(cpu.geom, cpu.instances,
                                   torch_parity.rays8(r8),
                                   tri_mat=cpu.tri_mat)
    for k in ("prim_id", "inst_id", "mat_id"):
        np.testing.assert_array_equal(getattr(hits, k).cpu().numpy(),
                                      getattr(ref, k).numpy())


def test_bf_wrappers_check_arguments(cuda):
    geom, tri_mat, rays = _mesh_and_rays(8, 64, 1, cuda)
    with pytest.raises(TypeError):
        pallas_bf.closest_hit(geom.tri_consts, tri_mat.long(), rays)
    bad = Rays(rays.origin.double(), rays.direction, rays.tmin, rays.tmax)
    with pytest.raises(TypeError):
        pallas_bf.any_hit(geom.tri_consts, bad)
    geom, tri_mat, rays = _mesh_and_rays(40, 64, 1, cuda)
    with pytest.raises(ValueError):             # boxes of another group size
        pallas_bf.closest_hit(geom.tri_consts, tri_mat, rays,
                              boxes=fused_group_boxes(geom, 4))
    with pytest.raises(ValueError):             # a table off 16 bytes
        flat = torch.zeros(40 * 16 + 1, device=cuda)
        pallas_bf.any_hit(flat[1:].view(40, 16), rays)


def test_fused_kernel_matches_plain(cuda):
    scene = cornell_box(cuda)
    w, h = 48, 40
    cam = cornell_camera(w, h).params(cuda)
    before = kernels.LAUNCHES["pt_fused_cornell"]
    out, count = pallas_pt.render_sum_fused(scene, cam, w, h,
                                            torch.tensor(7, device=cuda),
                                            samples_per_launch=2, max_depth=3)
    assert kernels.LAUNCHES["pt_fused_cornell"] == before + 1
    ref, ref_count = pallas_pt.render_sum_plain(scene, cam, w, h, 7,
                                                samples_per_launch=2,
                                                max_depth=3)
    assert int(count) == int(ref_count)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               atol=2e-3, rtol=1e-3)


def test_fused_kernel_row_tiles(cuda):
    scene = cornell_box(cuda)
    w, h = 32, 32
    cam = cornell_camera(w, h).params(cuda)
    full, c_full = pallas_pt.render_sum_fused(scene, cam, w, h, 0,
                                              samples_per_launch=2,
                                              max_depth=2)
    parts = [pallas_pt.render_sum_fused(scene, cam, w, 16, 0,
                                        samples_per_launch=2, max_depth=2,
                                        y0=y0, full_width=w, full_height=h)
             for y0 in (0, 16)]
    np.testing.assert_array_equal(
        torch.cat([p[0] for p in parts]).cpu().numpy(), full.cpu().numpy())
    assert sum(int(p[1]) for p in parts) == int(c_full)


def test_kernels_launch_span_holds_the_fused_launch(cuda):
    """Mapped onto the profiler's clock (telemetry.clock_offset_ns), each
    `kernels.launch` span of a Cornell launch holds the `cudaLaunchKernel`
    call of the `pt_fused_kernel` it started, and carries its LAUNCHES
    key."""
    from torch.profiler import ProfilerActivity, profile

    from optix_raytracer_tpu_torch import telemetry
    scene = cornell_box(cuda)
    w, h = 64, 48
    cam = cornell_camera(w, h).params(cuda)
    film = engine.render_accumulate(scene, cam, Film.create(h, w, cuda), w,
                                    h, samples_per_launch=2)[0]
    torch.cuda.synchronize()
    telemetry.reset_spans()
    telemetry.enable()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                film = engine.render_accumulate(scene, cam, film, w, h,
                                                samples_per_launch=2)[0]
            torch.cuda.synchronize()
            offset = telemetry.clock_offset_ns()
    finally:
        telemetry.disable()
    spans = [s for s in telemetry.drain() if s.name == "kernels.launch"]
    events = prof.profiler.kineto_results.events()
    fused = {e.correlation_id() for e in events
             if e.device_type() == torch.autograd.DeviceType.CUDA
             and "pt_fused_kernel" in e.name()}
    calls = [e for e in events if e.name() == "cudaLaunchKernel"
             and e.correlation_id() in fused]
    assert len(spans) == len(calls) == 3
    for s, c in zip(spans, sorted(calls, key=lambda c: c.start_ns())):
        assert s.tag == "pt_fused_cornell"
        assert s.start <= c.start_ns() - offset
        assert c.end_ns() - offset <= s.end


@pytest.mark.parametrize("name", ["cornell", "textured"])
def test_fused_launch_makes_no_sync(cuda, name):
    """After one warm-up launch, which builds the launch plan, a fused
    `engine.render_accumulate` with the film's device subframe makes no
    host-device sync (torch.cuda.set_sync_debug_mode("error")) and reuses
    its plan; the textured scene packs its spread column on the device."""
    w, h = 40, 32
    if name == "cornell":
        scene, cam = cornell_box(cuda), cornell_camera(w, h).params(cuda)
    else:
        scene = B.textured_scene(cuda, (32, 16, 16, 8), 0.6, 0.8)
        cam = B.textured_camera(w, h).params(cuda)
    assert engine._use_fused(scene, "auto")
    film = engine.render_accumulate(scene, cam, Film.create(h, w, cuda), w,
                                    h, samples_per_launch=2, max_depth=3)[0]
    torch.cuda.synchronize()
    before = dict(pallas_pt.PLANS)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            film, rays = engine.render_accumulate(scene, cam, film, w, h,
                                                  samples_per_launch=2,
                                                  max_depth=3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert pallas_pt.PLANS["built"] == before["built"]
    assert pallas_pt.PLANS["reused"] == before["reused"] + 3
    assert int(film.subframe) == 8 and int(rays) > 0


def _knot_rays(n, seed, device):
    """Rays toward the small knot with mixed windows, some dead."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rng.choice([1e16, 5.0, 9.0], n).astype(np.float32)
    tmax[::7] = 0.0
    return Rays(*(torch.as_tensor(a, device=device) for a in (
        o, d, np.full(n, 1e-3, np.float32), tmax)))


def _assert_hits_equal(out, ref):
    for k in ("prim_id", "mat_id", "inst_id"):
        np.testing.assert_array_equal(getattr(out, k).cpu().numpy(),
                                      getattr(ref, k).cpu().numpy())
    hit = ref.prim_id.cpu().numpy() >= 0
    assert hit.any() and (~hit).any()
    for k, tol in (("t", dict(rtol=1e-5)), ("uv", dict(atol=1e-4)),
                   ("normal", dict(atol=1e-5))):
        np.testing.assert_allclose(getattr(out, k).cpu().numpy(),
                                   getattr(ref, k).cpu().numpy(), **tol)


@pytest.mark.parametrize("exact,gate,segments,sides,case,max_clusters", [
    pytest.param(False, False, 20, 14, "random", 1024, id="False-False-20-14"),
    pytest.param(True, False, 20, 14, "random", 1024, id="True-False-20-14"),
    pytest.param(True, True, 20, 14, "random", 1024, id="True-True-20-14"),
    pytest.param(True, True, 512, 125, "random", 1024,
                 id="True-True-512-125"),
    pytest.param(False, False, 90, 50, "grazing", 1024,
                 id="grazing-False-False-90-50"),
    pytest.param(True, True, 90, 50, "grazing", 1024,
                 id="grazing-True-True-90-50"),
    pytest.param(True, True, 90, 50, "lone", 1024, id="lone-True-True-90-50"),
    pytest.param(True, False, 90, 50, "lone", 1024,
                 id="lone-True-False-90-50"),
    pytest.param(False, False, 0, 0, "ties", 1024, id="ties-False-False"),
    pytest.param(True, True, 0, 0, "ties", 1024, id="ties-True-True"),
    pytest.param(True, True, 20, 14, "random", 2, id="stream-20-14"),
    pytest.param(False, False, 90, 50, "grazing", 2, id="stream-grazing")])
def test_cluster_kernels_match_plain(cuda, monkeypatch, exact, gate,
                                     segments, sides, case, max_clusters):
    """Kernels 4-6 against their plain versions on the same inputs: the
    cull tables, the walks' rows and occlusion bit-equal. The 128,002-
    triangle knot has 1,001 clusters, the resident tier's c_pad of 1024
    (four clusters per cull thread). "grazing": torch_parity.sc_grazing_rays
    on the 71 cluster boxes of the 9,002-triangle knot; "lone":
    torch_parity.lone_gated_rays, a grazing ray alone in its gated group
    whose accepted hit lies in a cluster only another group's ray crosses;
    "ties": torch_parity.sc_tie_case's exact ties at t = 1 across clusters
    and slots. MAX_CLUSTERS = 2 takes the streaming tier's cull (interval,
    no gate bits)."""
    monkeypatch.setattr(C, "MAX_CLUSTERS", max_clusters)
    if case == "ties":
        geom, tri_mat, order, rays8, _ = torch_parity.sc_tie_case(cuda)
        cl = C.build_clusters(geom, tri_mat, order=order)
    else:
        scene = knot_scene(segments, sides, device=cuda)
        cl = scene.clusters
        if case == "grazing":
            rays8 = torch_parity.sc_grazing_rays(
                scene.geom, cl, C._entry_boxes(cl.aabb), seed=3)
        elif case == "lone":
            rays8 = torch_parity.lone_gated_rays(scene.geom, cl)
    if case == "random":
        rays = _knot_rays(20000, 5, cuda)
    else:
        rays = Rays(*(torch.as_tensor(rays8[:, i], device=cuda)
                      for i in (slice(0, 3), slice(3, 6), 6, 7)))
    n = rays.tmin.shape[0]
    packed = C._pack_rays(rays, C._padded(n))
    nb, c_pad = packed.shape[0] // C.SUB, cl.c_pad
    if exact and c_pad <= C.MAX_CLUSTERS:
        before = kernels.LAUNCHES["cluster_cull_exact"]
        tn, gm = C.exact_cull(cl.aabb, packed, nb, c_pad)
        assert kernels.LAUNCHES["cluster_cull_exact"] == before + 1
        tn_p, gm_p = C.exact_cull_plain(cl.aabb, packed, nb, c_pad)
        assert torch.equal(tn.view(torch.int32), tn_p.view(torch.int32))
        assert torch.equal(gm, gm_p)
    counts, lists, tnear = C._cull(cl, packed, nb // C.GROUPS, c_pad,
                                   exact=exact)
    args = (counts, lists, tnear, cl.comp, cl.aabb, packed, gate)
    before = dict(kernels.LAUNCHES)
    rows, rows_p = C.walk_closest(*args), C.walk_closest_plain(*args)
    occ, occ_p = C.walk_any(*args), C.walk_any_plain(*args)
    torch.cuda.synchronize()
    for name in ("cluster_closest", "cluster_any"):
        assert kernels.LAUNCHES[name] == before[name] + 1
    assert torch.equal(rows.view(torch.int32), rows_p.view(torch.int32))
    assert torch.equal(occ, occ_p)
    assert int(occ.sum()) > 0
    if case == "random":
        live = torch.repeat_interleave(counts.reshape(-1) > 0, C.SUB)[:n]
        _assert_hits_equal(C._hits_from_rows(rows[:n], live, rays.tmax),
                           C._hits_from_rows(rows_p[:n], live, rays.tmax))
        assert int(occ.sum()) < n


@pytest.mark.parametrize("window", [1, 3, 8, 16, 32])
def test_cluster_walk_windows(cuda, monkeypatch, window):
    """Kernels 5 / 6 give the plain walks' rows and occlusion bit for bit
    at any round width (WALK_WINDOW, list entries a round) from 1 to 32."""
    monkeypatch.setattr(C, "WALK_WINDOW", window)
    cl = knot_scene(90, 50, device=cuda).clusters
    rays = _knot_rays(20000, 8, cuda)
    packed = C._pack_rays(rays, C._padded(rays.tmin.shape[0]))
    nb = packed.shape[0] // C.SUB
    for exact, gate in ((False, False), (True, True)):
        counts, lists, tnear = C._cull(cl, packed, nb // C.GROUPS, cl.c_pad,
                                       exact=exact)
        args = (counts, lists, tnear, cl.comp, cl.aabb, packed, gate)
        assert torch.equal(C.walk_closest(*args).view(torch.int32),
                           C.walk_closest_plain(*args).view(torch.int32))
        assert torch.equal(C.walk_any(*args), C.walk_any_plain(*args))


@pytest.mark.parametrize("max_clusters", [1024, 2])
def test_cluster_queries_match_cpu(cuda, monkeypatch, max_clusters):
    """Whole queries on the card (kernels) against the same queries on CPU
    tensors (plain versions); MAX_CLUSTERS = 2 takes the streaming tier's
    dispatch (interval cull, no gating)."""
    monkeypatch.setattr(C, "MAX_CLUSTERS", max_clusters)
    gpu = knot_scene(20, 14, device=cuda).clusters
    cpu = knot_scene(20, 14, device="cpu").clusters
    rays = _knot_rays(9000, 6, "cpu")
    rays_g = Rays(*(getattr(rays, f).to(cuda) for f in
                    ("origin", "direction", "tmin", "tmax")))
    for exact in (False, True):
        _assert_hits_equal(C.closest_hit(gpu, rays_g, exact=exact,
                                         group_walk=True),
                           C.closest_hit(cpu, rays, exact=exact,
                                         group_walk=True))
        assert torch.equal(C.any_hit(gpu, rays_g, exact=exact).cpu(),
                           C.any_hit(cpu, rays, exact=exact))
    _assert_hits_equal(C.closest_hit_sorted(gpu, rays_g),
                       C.closest_hit_sorted(cpu, rays))
    assert torch.equal(C.any_hit_sorted(gpu, rays_g).cpu(),
                       C.any_hit_sorted(cpu, rays))


def _sc_tier(monkeypatch, members, segments, sides, device):
    """The knot's table at the supercluster tier (stream cap lowered to 2,
    `members` clusters per supercluster)."""
    monkeypatch.setattr(C, "MAX_STREAM_CLUSTERS", 2)
    monkeypatch.setattr(C, "SC_CLUSTERS", members)
    return knot_scene(segments, sides, device=device).clusters


@pytest.mark.parametrize("exact,members,segments,sides,case", [
    pytest.param(False, 32, 90, 50, "random", id="False-32-90-50"),
    pytest.param(True, 32, 90, 50, "random", id="True-32-90-50"),
    pytest.param(True, 2, 20, 14, "random", id="True-2-20-14"),
    pytest.param(False, 32, 90, 50, "grazing", id="grazing-False-32-90-50"),
    pytest.param(True, 32, 90, 50, "grazing", id="grazing-True-32-90-50"),
    pytest.param(True, 2, 20, 14, "grazing", id="grazing-True-2-20-14"),
    pytest.param(False, 32, 90, 50, "lone", id="lone-False-32-90-50"),
    pytest.param(True, 32, 90, 50, "lone", id="lone-True-32-90-50"),
    pytest.param(True, 32, 90, 50, "lone_pair",
                 id="lone-pair-True-32-90-50"),
    pytest.param(False, 32, 90, 50, "lone_pair",
                 id="lone-pair-False-32-90-50"),
    pytest.param(False, 2, 0, 0, "ties", id="ties-False-2"),
    pytest.param(True, 2, 0, 0, "ties", id="ties-True-2")])
def test_sc_kernels_match_plain(cuda, monkeypatch, exact, members, segments,
                                sides, case):
    """Kernels 5c / 6c against their plain versions on the same lists: rows
    bit-equal, occlusion equal. The 9,002-triangle knot is 3 superclusters
    of the real 32 members; the small knot 3 of 2. "random": rays toward
    the knot; "grazing": torch_parity.sc_grazing_rays (faces, edges, the
    vertices that set a face, +-0 directions, windows ending on a face);
    "lone": torch_parity.sc_lone_grazing_rays, one live ray a block whose
    accepted hit lies outside the block union; "lone_pair":
    torch_parity.lone_gated_rays, a grazing ray whose accepted hit lies in
    a member only another ray of its block crosses, so the member is in
    the block union but the grazing ray is not among the rays the cull's
    entry bound covers; "ties":
    torch_parity.sc_tie_case's exact ties at t = 1, whose winners (earlier
    visit at an equal slot, then the lower slot) are checked."""
    expect = None
    if case == "ties":
        monkeypatch.setattr(C, "MAX_STREAM_CLUSTERS", 2)
        monkeypatch.setattr(C, "SC_CLUSTERS", 2)
        geom, tri_mat, order, rays8, expect = torch_parity.sc_tie_case(cuda)
        cl = C.build_clusters(geom, tri_mat, order=order)
    else:
        monkeypatch.setattr(C, "MAX_STREAM_CLUSTERS", 2)
        monkeypatch.setattr(C, "SC_CLUSTERS", members)
        scene = knot_scene(segments, sides, device=cuda)
        cl = scene.clusters
        if case == "grazing":
            rays8 = torch_parity.sc_grazing_rays(
                scene.geom, cl, C._sc_tables(cl)[1], seed=members)
        elif case == "lone":
            rays8 = torch_parity.sc_lone_grazing_rays(
                scene.geom, cl, C._sc_tables(cl)[1])
        elif case == "lone_pair":
            rays8 = torch_parity.lone_gated_rays(scene.geom, cl)
    if case == "random":
        rays = _knot_rays(20000, 5, cuda)
    else:
        rays = Rays(*(torch.as_tensor(rays8[:, i], device=cuda)
                      for i in (slice(0, 3), slice(3, 6), 6, 7)))
    n = rays.tmin.shape[0]
    packed = C._pack_rays(rays, C._padded(n))
    counts, lists, tnear, member = C._tier_cull(cl, packed, exact)
    assert member.shape[2] == members and int(counts.max()) > 0
    args = (counts, lists, tnear, cl.comp, member, packed)
    before = dict(kernels.LAUNCHES)
    rows, rows_p = C.walk_sc_closest(*args), C.walk_sc_closest_plain(*args)
    occ, occ_p = C.walk_sc_any(*args), C.walk_sc_any_plain(*args)
    torch.cuda.synchronize()
    for name in ("cluster_sc_closest", "cluster_sc_any"):
        assert kernels.LAUNCHES[name] == before[name] + 1
    assert torch.equal(rows.view(torch.int32), rows_p.view(torch.int32))
    assert torch.equal(occ, occ_p)
    live = torch.repeat_interleave(counts.reshape(-1) > 0, C.SUB)[:n]
    hits = C._hits_from_rows(rows[:n], live, rays.tmax)
    if case.startswith("lone"):
        return
    assert 0 < int(occ.sum())
    if expect is None:
        assert int(occ.sum()) < n
        assert (hits.prim_id >= 0).any() and (hits.prim_id < 0).any()
    else:
        check = torch.as_tensor(expect >= 0, device=cuda)
        assert torch.equal(hits.prim_id[check].long().cpu(),
                           torch.as_tensor(expect[expect >= 0]))


def test_sc_queries_match_cpu(cuda, monkeypatch):
    """Whole queries at the supercluster tier on the card (kernels 4, 5c,
    6c) against the same queries on CPU tensors (plain versions)."""
    gpu = _sc_tier(monkeypatch, 32, 90, 50, cuda)
    cpu = _sc_tier(monkeypatch, 32, 90, 50, "cpu")
    rays = _knot_rays(9000, 6, "cpu")
    rays_g = Rays(*(getattr(rays, f).to(cuda) for f in
                    ("origin", "direction", "tmin", "tmax")))
    for exact in (False, True):
        _assert_hits_equal(C.closest_hit(gpu, rays_g, exact=exact),
                           C.closest_hit(cpu, rays, exact=exact))
        assert torch.equal(C.any_hit(gpu, rays_g, exact=exact).cpu(),
                           C.any_hit(cpu, rays, exact=exact))
    _assert_hits_equal(C.closest_hit_sorted(gpu, rays_g),
                       C.closest_hit_sorted(cpu, rays))
    assert torch.equal(C.any_hit_sorted(gpu, rays_g).cpu(),
                       C.any_hit_sorted(cpu, rays))


def _rays8(rays8, device):
    """[N, 8] f32 numpy rays → Rays on device."""
    t = torch.as_tensor(rays8, device=device)
    return Rays(t[:, 0:3].contiguous(), t[:, 3:6].contiguous(),
                t[:, 6].contiguous(), t[:, 7].contiguous())


def _queue_case(case, device):
    """(cluster table, rays) of one case of test_qwalk_kernels_match_plain."""
    if case in ("knot20x14", "knot512x125", "padding"):
        segments, sides = (512, 125) if case == "knot512x125" else (20, 14)
        rays = _knot_rays(20000, 5, device)
        if case == "padding":      # a few live rays: most items are padding
            keep = torch.arange(20000, device=device) % 401 == 0
            rays = Rays(rays.origin, rays.direction, rays.tmin,
                        torch.where(keep, rays.tmax, 0.0))
        return knot_scene(segments, sides, device=device).clusters, rays
    if case == "tie":
        geom, tri_mat, order, rays8, _ = torch_parity.sc_tie_case(device)
        return (C.build_clusters(geom, tri_mat, order=order),
                _rays8(rays8, device))
    scene = knot_scene(90, 50, device=device)
    cl = scene.clusters
    if case == "edge":
        rays8 = np.concatenate([torch_parity.cull_edge_rays(
            cl.aabb.cpu().numpy(), s) for s in (0, 1)])
    elif case == "grazing":
        boxes = C._entry_boxes(cl.aabb)[:cl.num_clusters]
        rays8 = np.concatenate([torch_parity.sc_grazing_rays(
            scene.geom, cl, boxes, seed=s, boxes=71) for s in range(4)])
    elif case == "lone":
        rays8 = torch_parity.lone_gated_rays(scene.geom, cl)
    else:                          # "all_miss"
        rays8 = torch_parity.queue_miss_rays(cl)
    return cl, _rays8(rays8, device)


@pytest.mark.parametrize("case", ["knot20x14", "knot512x125", "edge",
                                  "grazing", "lone", "all_miss", "tie",
                                  "padding"])
def test_qwalk_kernels_match_plain(cuda, case):
    """Kernel 7's octet masks and kernel 8's candidate columns (closest and
    any-hit) against their plain versions on the same work list, bit-equal:
    random rays on the small knot and on the 128,002-triangle knot (1,001
    clusters, four per cull thread); on the 9k knot the cull's edge-case
    rays, grazing rays and rays alone in their octet, and whole steps
    whose admitted rays all miss
    (torch_parity.queue_miss_rays); exact ties (sc_tie_case at the
    resident tier: two copies of a triangle in one cluster, the lower slot
    wins); and a list of mostly padding items."""
    from optix_raytracer_tpu_torch.accel import qwalk as Q
    cl, rays = _queue_case(case, cuda)
    n, n_padded, packed, nb, c_pad, _ = Q._prep(cl, rays, 6)
    before = dict(kernels.LAUNCHES)
    om = Q._oct_cull(cl, packed, nb, c_pad)
    assert torch.equal(om, Q.oct_cull_plain(cl.aabb, packed, nb, c_pad))
    # a capacity that holds the whole list
    steps, work, overflow, n_items = Q._build_queue(
        om, cl.num_clusters, n_padded, 1 << 22)
    assert not overflow and n_items > 0
    qrays, _ = Q._marshal(packed, work[:n_items], n_padded)
    live = steps[:, :n_items // Q.ITEMS].contiguous()
    adm = Q.queue_admitted_plain(live, qrays, cl.aabb)
    assert adm.any()
    for closest in (True, False):
        out = Q._run_queue(closest, cl.comp, live, qrays, cl.aabb)
        plain = (Q.queue_closest_plain if closest else Q.queue_any_plain)(
            live, qrays, cl.comp)
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int32), plain.view(torch.int32))
        hit = out[6] >= 0 if closest else out[0] > 0
        assert hit.any() == (case != "all_miss")
        assert int(hit.sum()) < out.shape[1]
    for name in ("qwalk_oct_cull", "qwalk_closest", "qwalk_any"):
        assert kernels.LAUNCHES[name] == before[name] + 1
    with pytest.raises(ValueError, match="cluster boxes"):
        Q._run_queue(True, cl.comp, live, qrays)


def _assert_culls_match_plain(aabb, packed, what):
    """Kernels 4 and 7 against their plain versions on one table and ray
    set: tn, gm and om bit-equal, one launch each."""
    from optix_raytracer_tpu_torch.accel import qwalk as Q
    nb, c_pad = packed.shape[0] // C.SUB, aabb.shape[0] * C.LANES
    before = dict(kernels.LAUNCHES)
    tn, gm = C.exact_cull(aabb, packed, nb, c_pad)
    om = Q._oct_cull(types.SimpleNamespace(aabb=aabb), packed, nb, c_pad)
    torch.cuda.synchronize()
    for name in ("cluster_cull_exact", "qwalk_oct_cull"):
        assert kernels.LAUNCHES[name] == before[name] + 1
    tn_p, gm_p = C.exact_cull_plain(aabb, packed, nb, c_pad)
    assert torch.equal(tn.view(torch.int32), tn_p.view(torch.int32)), what
    assert torch.equal(gm, gm_p), what
    assert torch.equal(om, Q.oct_cull_plain(aabb, packed, nb, c_pad)), what
    assert (gm != 0).any(), what
    return tn, gm


def _edge_sets(aabb, device, seeds=(0, 1)):
    return [torch.as_tensor(torch_parity.cull_edge_rays(
        aabb.cpu().numpy(), seed), device=device) for seed in seeds]


@pytest.mark.parametrize("group", C.CULL_GROUPS)
def test_cull_kernels_match_plain(cuda, monkeypatch, group):
    """Kernels 4 and 7 at each group size against their plain versions, bit
    for bit: the edge-case rays (torch_parity.cull_edge_rays, with a dead
    block and a block of one live ray) on the edge-case table
    (torch_parity.cull_edge_table: interleaved padding, other inverted
    boxes) and on the 25k knot's table; the 25k knot's probe sets at
    64x64 (knot_probe.knot_ray_sets); and the cluster queries of one
    sample-major strip of the 25k knot at 64x64, 4 samples, depth 3."""
    from optix_raytracer_tpu_torch.tools import knot_probe as KP
    monkeypatch.setattr(C, "cull_group", lambda c_pad: group)
    knot = knot_scene(200, 63, device=cuda)
    edge = torch.as_tensor(torch_parity.cull_edge_table(), device=cuda)
    for name, aabb in (("edge", edge), ("knot25k", knot.clusters.aabb)):
        for i, packed in enumerate(_edge_sets(aabb, cuda)):
            tn, gm = _assert_culls_match_plain(aabb, packed,
                                               f"{name} edge rays {i}")
            assert (gm[2] == 0).all() and (tn[2] == C._BIG).all()
            assert (gm[5] != 0).any()
            assert ((gm[5] == 0) | (gm[5] == 1 << (77 // 32))).all()
    prim, shadow, bounce1 = KP.knot_ray_sets(knot, 64, 64, cuda)
    closest, shadows = KP.main_path_strip_sets(
        knot, knot_camera(64, 64).params(cuda), 64, 64, 4, 3)
    sets = [prim, shadow, bounce1] + [r for r, _, _ in closest + shadows]
    for i, rays in enumerate(sets):
        packed = C._pack_rays(rays, C._padded(rays.tmin.shape[0]))
        _assert_culls_match_plain(knot.clusters.aabb, packed,
                                  f"knot25k set {i}")


@pytest.mark.parametrize("group", C.CULL_GROUPS)
def test_cull_kernels_match_plain_sc_facade(cuda, monkeypatch, group):
    """The same on a supercluster facade of c_pad 1024: the 500,000-triangle
    knot (trefoil_mesh(1000, 250), 3,907 clusters) on the supercluster tier
    at 4 clusters a supercluster (977 superclusters), with the edge-case
    rays and random rays around the mesh."""
    from optix_raytracer_tpu_torch.accel import native
    monkeypatch.setattr(C, "cull_group", lambda c_pad: group)
    monkeypatch.setattr(C, "MAX_STREAM_CLUSTERS", 2)
    monkeypatch.setattr(C, "SC_CLUSTERS", 4)
    verts, idx, normals = B.trefoil_mesh(1000, 250)
    geom = build_triangle_geometry(verts, idx, cuda, normals=normals)
    cl = C.build_clusters(geom, order=native.sah_leaf_order(geom))
    cull_aabb, _, n_sc = C._sc_tables(cl)
    facade = C._sc_facade(cl, cull_aabb, n_sc)
    assert facade.c_pad == 1024 and n_sc == 977
    sets = _edge_sets(facade.aabb, cuda, seeds=(2,))
    rays = _knot_rays(40000, 7, cuda)
    sets.append(C._pack_rays(rays, C._padded(rays.tmin.shape[0])))
    for i, packed in enumerate(sets):
        _assert_culls_match_plain(facade.aabb, packed, f"facade set {i}")


@pytest.mark.parametrize("qf", [6, 1])
def test_qwalk_queries_match_cpu(cuda, qf):
    """Whole queue queries on the card (kernels 7-8) against the same
    queries on CPU tensors (plain versions), and against the gated walk;
    qf = 1 overflows to the walk on both."""
    from optix_raytracer_tpu_torch.accel import qwalk as Q
    gpu = knot_scene(20, 14, device=cuda).clusters
    cpu = knot_scene(20, 14, device="cpu").clusters
    rays = _knot_rays(9000, 6, "cpu")
    rays_g = Rays(*(getattr(rays, f).to(cuda) for f in
                    ("origin", "direction", "tmin", "tmax")))
    Q.reset_stats()
    hits = Q.closest_hit(gpu, rays_g, qf=qf)
    _assert_hits_equal(hits, Q.closest_hit(cpu, rays, qf=qf))
    _assert_hits_equal(hits, C.closest_hit(gpu, rays_g, exact=True,
                                           group_walk=True))
    occ = Q.any_hit(gpu, rays_g, qf=qf).cpu()
    assert torch.equal(occ, Q.any_hit(cpu, rays, qf=qf))
    assert torch.equal(occ, C.any_hit(cpu, rays, exact=True))
    kind = "overflow" if qf == 1 else "queue"
    assert Q.STATS[f"closest_{kind}"] == 2 and Q.STATS[f"any_{kind}"] == 2


def test_knot_launch_on_card(cuda):
    """The knot's sample-major launch against its sequential oracle on the
    card, and against the same launch on the CPU."""
    w, h = 32, 24
    runs = {}
    for dev, impl in ((cuda, "auto"), (cuda, "wavefront"), ("cpu", "auto")):
        scene = knot_scene(20, 14, device=dev)
        film, rays = engine.render_accumulate(
            scene, knot_camera(w, h).params(dev), Film.create(h, w, dev), w,
            h, samples_per_launch=8, max_depth=3, impl=impl)
        runs[(str(dev), impl)] = (film.accum.cpu().numpy(), int(rays))
    ref_img, ref_rays = runs[("cpu", "auto")]
    for img, rays in runs.values():
        assert rays == ref_rays
        np.testing.assert_allclose(img, ref_img, atol=2e-3, rtol=1e-3)


def _variant_scene(name, device):
    """A scene per instantiation <geometry, specular, pbr, prims> of the
    fused kernel (kernels.pt_fused_name) and its camera: the bench's prims
    and PBR scenes, the mirror Cornell, the instanced Cornell, the
    instanced cube with prims, the small smooth knot, and
    builtins.fused_mix_scene's mixes."""
    import dataclasses
    from optix_raytracer_tpu_torch.accel import primitives as prim
    from optix_raytracer_tpu_torch.core.camera import Camera
    from optix_raytracer_tpu_torch.scene import builtins as B
    from torch_parity import instanced_cube
    if name in B.FUSED_MIXES:
        return B.fused_mix_scene(name, device)
    if name == "pt_fused_inst":
        return B.cornell_box_instanced(device), B.cornell_camera
    if name == "pt_fused_inst_prims":
        scene = dataclasses.replace(instanced_cube("torch", device),
                                    prims=prim.make_prims(
                                        B.prims_list(False), device))
        return scene, lambda w, h: Camera(eye=(0, 2.5, -5.0),
                                          lookat=(0, 0.3, 0), up=(0, 1, 0),
                                          fov_y=45.0, aspect=w / h)
    if name == "pt_fused_smooth":
        return B.knot_scene(8, 6, device=device), B.knot_camera
    if name == "pt_fused_specular_prims":
        return B.prims_scene(device), B.prims_camera
    if name == "pt_fused_specular":
        return B.pbr_cornell(device, 1.0, 0.02), B.cornell_camera
    return B.pbr_cornell(device), B.cornell_camera


_VARIANTS = ["pt_fused_prims", "pt_fused_specular_prims", "pt_fused_pbr",
             "pt_fused_specular", "pt_fused_pbr_prims",
             "pt_fused_specular_pbr", "pt_fused_specular_pbr_prims",
             "pt_fused_inst", "pt_fused_inst_prims", "pt_fused_smooth",
             "pt_fused_smooth_pbr", "pt_fused_smooth_specular"]


@pytest.mark.parametrize("name", _VARIANTS)
def test_fused_variants_match_plain(cuda, name):
    """Each instantiation of kernel 3' against the wavefront engine on the
    card (on an instanced scene kernels 1-2 per instance, on a smooth one
    with the shading-frame epilogue): its own LAUNCHES key, ray counts
    equal, radiance within atol 3e-3 / rtol 1e-3 (test_fused_kernel.py:238),
    regen a no-op, row tiles equal to the full frame."""
    scene, camera = _variant_scene(name, cuda)
    assert kernels.pt_fused_name(*pallas_pt.fused_variant(scene)) == name
    assert engine._use_fused(scene, "auto")
    w, h = 40, 32
    cam = camera(w, h).params(cuda)
    before = dict(kernels.LAUNCHES)
    out, count = pallas_pt.render_sum_fused(scene, cam, w, h, 5,
                                            samples_per_launch=2, max_depth=3)
    assert kernels.LAUNCHES[name] == before[name] + 1
    assert all(kernels.LAUNCHES[k] == v for k, v in before.items()
               if k != name)
    ref, ref_count = pallas_pt.render_sum_plain(scene, cam, w, h, 5,
                                                samples_per_launch=2,
                                                max_depth=3)
    assert int(count) == int(ref_count)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               atol=3e-3, rtol=1e-3)
    assert float(ref.max()) > 0.05
    again, c_again = pallas_pt.render_sum_fused(scene, cam, w, h, 5,
                                                samples_per_launch=2,
                                                max_depth=3, regen=True)
    np.testing.assert_array_equal(again.cpu().numpy(), out.cpu().numpy())
    assert int(c_again) == int(count)
    parts = [pallas_pt.render_sum_fused(scene, cam, w, 16, 5,
                                        samples_per_launch=2, max_depth=3,
                                        y0=y0, full_width=w, full_height=h)
             for y0 in (0, 16)]
    np.testing.assert_array_equal(
        torch.cat([p[0] for p in parts]).cpu().numpy(), out.cpu().numpy())


@pytest.mark.parametrize("name,culled",
                         [(n, False) for n in kernels.FUSED_INSTANTIATIONS]
                         + [(n, True) for n in kernels.FUSED_INSTANTIATIONS
                            if not n.startswith("pt_fused_inst")])
def test_fused_instantiations_bit_equal_to_wavefront(cuda, name, culled):
    """Each of the kernel's 32 instantiations against the wavefront engine
    (its plain version, kernels 1-2 on the card) at 64², spl 2, depth 3:
    its own LAUNCHES key, images and ray counts bit-equal; on small tables
    tested whole (group = the table) and, outside instances, on tables it
    culls by groups (fused_variant_scene(culled=True), the scene's own
    group size)."""
    scene, camera = B.fused_variant_scene(name, cuda, culled)
    assert kernels.pt_fused_name(*pallas_pt.fused_variant(scene)) == name
    group = (pallas_pt.fused_group_size(scene) if culled
             else scene.num_triangles)
    assert (group < scene.num_triangles) == culled
    assert engine._use_fused(scene, "auto")
    w = h = 64
    cam = camera(w, h).params(cuda)
    before = dict(kernels.LAUNCHES)
    out, count = pallas_pt.render_sum_fused(scene, cam, w, h, 5,
                                            samples_per_launch=2, max_depth=3,
                                            group=group)
    assert kernels.LAUNCHES[name] == before[name] + 1
    ref, ref_count = pallas_pt.render_sum_plain(scene, cam, w, h, 5,
                                                samples_per_launch=2,
                                                max_depth=3)
    assert int(count) == int(ref_count)
    assert float(ref.max()) > 0.05
    np.testing.assert_array_equal(out.cpu().numpy(), ref.cpu().numpy())


def _textured_scene(name, device):
    """The k1 scenes of chip_smoke.py: bench.py's textured scene (256 /
    128 / 128 / 64 maps, metallic and roughness 1), tests/test_fused_
    textures.py:29-63's smooth and base-map-only variants (32 / 16 / 16 / 8
    maps, metallic 0.6, roughness 0.8), and the all-maps one with a glass
    and a diffuse sphere (prims)."""
    import dataclasses
    from optix_raytracer_tpu_torch.accel import primitives as prim
    from optix_raytracer_tpu_torch.scene import builtins as B
    small = (32, 16, 16, 8)
    if name == "bench":
        return B.textured_scene(device)
    if name == "smooth":
        return B.textured_scene(device, small, 0.6, 0.8, smooth=True)
    if name == "base":
        return B.textured_scene(device, small, 0.6, 0.8, maps="base")
    scene = B.textured_scene(device, small, 0.6, 0.8)
    mats = dataclasses.replace(scene.materials)
    glass = {"kind": 2, "base_color": (0.95, 0.95, 0.95), "ior": 1.5}
    extra = {"kind": 0, "base_color": (0.2, 0.4, 0.8)}
    from optix_raytracer_tpu_torch.shade.materials import make_material_table
    more = make_material_table([glass, extra], device)
    for f in dataclasses.fields(mats):
        setattr(mats, f.name, torch.cat([getattr(scene.materials, f.name),
                                         getattr(more, f.name)]))
    plist = [{"kind": prim.SPHERE, "center": (0.9, 0.5, -1.2),
              "radius": 0.4, "mat_id": 1},
             {"kind": prim.SPHERE, "center": (-1.0, 0.4, -1.4),
              "radius": 0.35, "mat_id": 2}]
    return dataclasses.replace(
        scene, materials=mats, prims=prim.make_prims(plist, device),
        features=("glass", "pbr"),
        mat_tex_flags=scene.mat_tex_flags + ((-1, False, False, False,
                                              False),) * 2)


# A PBR material with a metallic-roughness map takes the specular
# instantiation (DeviceScene.specular_lanes); the base-map-only one does not.
_TEXTURED = {"bench": "pt_fused_tex_specular_pbr",
             "smooth": "pt_fused_tex_specular_pbr", "base": "pt_fused_tex_pbr",
             "prims": "pt_fused_tex_specular_pbr_prims"}


@pytest.mark.parametrize("name", list(_TEXTURED))
def test_fused_textured_match_plain(cuda, name):
    """Each texture instantiation the k1 scenes reach against the wavefront's
    texture lanes on the card: its own LAUNCHES key, ray counts equal,
    radiance within atol 2e-3 / rtol 1e-3, row tiles equal to the full
    frame; "auto" takes it."""
    from optix_raytracer_tpu_torch.scene.builtins import textured_camera
    scene = _textured_scene(name, cuda)
    kname = _TEXTURED[name]
    assert kernels.pt_fused_name(*pallas_pt.fused_variant(scene)) == kname
    assert engine._use_fused(scene, "auto")
    w, h = 40, 32
    cam = textured_camera(w, h).params(cuda)
    before = dict(kernels.LAUNCHES)
    out, count = pallas_pt.render_sum_fused(scene, cam, w, h, 5,
                                            samples_per_launch=2, max_depth=3)
    assert kernels.LAUNCHES[kname] == before[kname] + 1
    assert all(kernels.LAUNCHES[k] == v for k, v in before.items()
               if k != kname)
    ref, ref_count = pallas_pt.render_sum_plain(scene, cam, w, h, 5,
                                                samples_per_launch=2,
                                                max_depth=3)
    assert int(count) == int(ref_count)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               atol=2e-3, rtol=1e-3)
    assert float(ref.max()) > 0.05
    parts = [pallas_pt.render_sum_fused(scene, cam, w, 16, 5,
                                        samples_per_launch=2, max_depth=3,
                                        y0=y0, full_width=w, full_height=h)
             for y0 in (0, 16)]
    np.testing.assert_array_equal(
        torch.cat([p[0] for p in parts]).cpu().numpy(), out.cpu().numpy())


@pytest.mark.parametrize("tile_w", [128, 256, 512])
def test_texfetch_matches_plain(cuda, tile_w):
    """Kernel 9 against its plain version at each tile width of the A/B,
    exactly, and against the atlas's own rows."""
    from optix_raytracer_tpu_torch.tools import bench_texfetch as T
    _, atlas_bf = T.make_atlas(cuda)
    idx, base, local = T.make_workload(T.BLOCK * 512, atlas_bf.shape[0],
                                       tile_w, seed=4, device=cuda)
    tile_idx, local2 = T.tile_window(base, local, tile_w)
    before = kernels.LAUNCHES["texfetch"]
    out = T.onehot_fetch(atlas_bf, tile_idx, local2, tile_w)
    assert kernels.LAUNCHES["texfetch"] == before + 1
    assert torch.equal(out, T.onehot_fetch_plain(atlas_bf, tile_idx, local2,
                                                 tile_w))
    assert torch.equal(out, atlas_bf[idx.long()].float())


def _whitted_case(name, device):
    """(scene, camera params, depth) at 64²: the Whitted scene (kernels 1-2)
    or the meshviewer's headlight rig on the 25k knot (kernels 4-6)."""
    from optix_raytracer_tpu_torch.apps.meshviewer import headlight_rig
    from optix_raytracer_tpu_torch.tools.whitted_probe import KNOT_RIG
    if name == "whitted":
        return (B.whitted_scene(device),
                B.whitted_camera(64, 64).params(device), 6)
    host = B.knot_host_scene(KNOT_RIG["segments"], KNOT_RIG["sides"])
    cam = host.default_camera(64, 64)
    return (host.finalize(device, lights=headlight_rig(cam)),
            cam.params(device), KNOT_RIG["depth"])


@pytest.mark.parametrize("name", ["whitted", "knot_rig"])
def test_whitted_kernels_bit_equal_to_plain(cuda, name):
    """One Whitted sample at 64² through the kernels (1-2 on the Whitted
    scene, 4-6 on the knot rig), each launched, bit-equal to the same
    sample with every query through the plain versions."""
    from optix_raytracer_tpu_torch.tools.whitted_probe import plain_queries
    from optix_raytracer_tpu_torch.wavefront.whitted import (
        render_whitted_sample)
    scene, cam, depth = _whitted_case(name, cuda)
    names = (("bf_closest", "bf_any") if name == "whitted" else
             ("cluster_cull_exact", "cluster_closest", "cluster_any"))
    kernels.reset_launches()
    out, rays = render_whitted_sample(scene, cam, 64, 64, 0, max_depth=depth)
    torch.cuda.synchronize()
    assert all(kernels.LAUNCHES[k] > 0 for k in names), kernels.LAUNCHES
    kernels.reset_launches()
    with plain_queries():
        ref, ref_rays = render_whitted_sample(scene, cam, 64, 64, 0,
                                              max_depth=depth)
    assert not any(kernels.LAUNCHES.values())
    assert int(rays) == int(ref_rays)
    assert float(ref.mean()) > 0.01
    np.testing.assert_array_equal(out.cpu().numpy(), ref.cpu().numpy())


def test_whitted_dead_lanes_reach_bf_kernels_dead(cuda):
    """On the card, the Whitted scene's queries hand kernels 1-2 a lane that
    has ended, or a shadow ray whose term is masked out, with tmax 0 <=
    tmin: per bounce the live closest lanes are among the last bounce's,
    the live shadow rays among the bounce's live lanes, and from bounce 1
    some lanes are dead."""
    from optix_raytracer_tpu_torch.tools.whitted_probe import recorded_queries
    from optix_raytracer_tpu_torch.wavefront.whitted import (
        render_whitted_sample)
    scene, cam, depth = _whitted_case("whitted", cuda)
    kernels.reset_launches()
    with recorded_queries() as calls:
        render_whitted_sample(scene, cam, 64, 64, 0, max_depth=depth)
    per = 1 + scene.lights.num
    assert len(calls) == depth * per
    assert kernels.LAUNCHES["bf_closest"] == depth
    assert kernels.LAUNCHES["bf_any"] == depth * scene.lights.num
    prev = None
    for b in range(depth):
        group = calls[b * per:(b + 1) * per]
        assert [c["route"] for c in group] == ["bf"] * per
        live = [c["rays"].tmax > c["rays"].tmin for c in group]
        assert bool(live[0].all()) == (b == 0)
        if prev is not None:
            assert not bool((live[0] & ~prev).any())
        for sh in live[1:]:
            assert not bool((sh & ~live[0]).any())
        prev = live[0]


@pytest.mark.parametrize("name", ["cutout_cornell", "opaque_alpha",
                                  "cutout_grid", "circle_grid"])
def test_cutout_occlusion_matches_plain(cuda, name):
    """bench.py's occlusion rays (65,536) on the cutout scenes: the micromap
    path, the loop and scene_any through the kernels (1-2, 4 + 6 on the
    grid's solid split) equal the same queries through the plain versions,
    and the micromap path equals the loop (on the circle grid, where the
    micromaps are not exact, only the plain parity is held)."""
    from optix_raytracer_tpu_torch.tools import cutout_probe as CP
    from optix_raytracer_tpu_torch.tools.whitted_probe import plain_queries
    scene = (CP.circle_grid(cuda) if name == "circle_grid"
             else CP.OCCLUSION_SCENES[name](cuda))
    rays = CP.occlusion_rays(name, 1 << 16, 5, cuda)
    out = {}
    for query in ("omm", "loop", "scene_any"):
        kernels.reset_launches()
        occ = CP.occlusion_query(scene, query, rays)
        assert any(kernels.LAUNCHES.values())
        with plain_queries():
            ref = CP.occlusion_query(scene, query, rays)
        assert torch.equal(occ, ref), query
        out[query] = occ
    assert 0.0 < float(out["omm"].float().mean()) < 1.0
    if name != "circle_grid":
        assert torch.equal(out["omm"], out["loop"])


@pytest.mark.parametrize("name", ["cutouts", "textured_cutout", "grid"])
def test_cutout_render_matches_plain(cuda, name):
    """One launch of the cut lanes on the card (the cutout Cornell and its
    textured variant at 64², 2 samples, depth 4: kernels 1-2; the cutout
    grid at 64², 8 samples, depth 3, sample-major: kernels 4-6) bit-equal
    to the same launch through the plain versions, rays equal."""
    from optix_raytracer_tpu_torch.apps import cutouts
    from optix_raytracer_tpu_torch.tools.whitted_probe import plain_queries
    scene, cam_fn, spl, depth = {
        "cutouts": (cutouts.cutout_cornell, B.cornell_camera, 2, 4),
        "textured_cutout": (cutouts.textured_cutout_cornell,
                            B.cornell_camera, 2, 4),
        "grid": (cutouts.cutout_grid, B.cutout_grid_camera, 8, 3)}[name]
    scene = scene(cuda)
    cam = cam_fn(64, 64).params(cuda)

    def launch():
        return engine.render_accumulate(scene, cam, Film.create(64, 64, cuda),
                                        64, 64, samples_per_launch=spl,
                                        max_depth=depth)
    kernels.reset_launches()
    film, rays = launch()
    need = ("cluster_closest", "cluster_any") if name == "grid" else (
        "bf_closest", "bf_any")
    assert all(kernels.LAUNCHES[k] > 0 for k in need)
    with plain_queries():
        ref, ref_rays = launch()
    assert int(rays) == int(ref_rays)
    np.testing.assert_array_equal(film.accum.cpu().numpy(),
                                  ref.accum.cpu().numpy())


@pytest.mark.parametrize("name", ["cornell", "smooth_knot", "textured"])
def test_denoise_aovs_match_plain(cuda, name):
    """render_aovs on the card (kernel 1 answers the camera query; the
    smooth knot's shading frame, the textured scene's base map) bit-equal
    to the same call through the plain versions, at 64x48."""
    from optix_raytracer_tpu_torch.tools.whitted_probe import plain_queries
    scene, camera = {
        "cornell": (B.cornell_box, B.cornell_camera),
        "smooth_knot": (lambda d: knot_scene(16, 15, device=d), knot_camera),
        "textured": (B.textured_whitted_scene,
                     B.textured_whitted_camera)}[name]
    scene, cam = scene(cuda), camera(64, 48).params(cuda)
    before = kernels.LAUNCHES["bf_closest"]
    aovs = engine.render_aovs(scene, cam, 64, 48)
    assert kernels.LAUNCHES["bf_closest"] > before
    with plain_queries():
        ref = engine.render_aovs(scene, cam, 64, 48)
    for k in ("albedo", "normal", "emission"):
        assert torch.equal(aovs[k], ref[k]), k


def test_denoise_matches_cpu(cuda):
    """Every invoke case of tools/denoise_probe.py (seven kinds on both
    backends, the alpha modes, the gate, blend, AOVs, flow trust, tiling)
    on the card against the CPU within atol / rtol 1e-3 (TF32 off in the
    net), and the optical flow equal."""
    from optix_raytracer_tpu_torch.tools import denoise_probe as DP
    errs = DP.matrix_parity(cuda, h=48, w=64)
    assert len(errs) == 2 * len(DP.CASES)


def test_denoise_net_and_filters_match_cpu(cuda):
    """The net (denoise_kp) and the filter (5 iterations) on the card
    against the CPU on the same 96x128 layers within atol / rtol 1e-3, and
    the optical flow equal."""
    from optix_raytracer_tpu_torch.denoise import atrous, flow, kpcnn
    from optix_raytracer_tpu_torch.tools import denoise_probe as DP
    d = DP.layers(3, 96, 128)
    params = kpcnn.load_params(device=cuda)
    cpu_params = kpcnn.load_params(device="cpu")
    beauty = torch.as_tensor(d["beauty"])
    albedo = torch.as_tensor(d["albedo"])
    normal = torch.as_tensor(d["normal"])
    pairs = [
        (kpcnn.denoise_kp(params, beauty.to(cuda), albedo.to(cuda),
                          normal.to(cuda)),
         kpcnn.denoise_kp(cpu_params, beauty, albedo, normal)),
        (atrous.denoise(beauty.to(cuda), albedo.to(cuda), normal.to(cuda)),
         atrous.denoise(beauty, albedo, normal))]
    for a, b in pairs:
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-3,
                                   rtol=1e-3)
    hist = torch.as_tensor(d["history"])
    np.testing.assert_array_equal(
        flow.optical_flow(beauty.to(cuda), hist.to(cuda)).cpu().numpy(),
        flow.optical_flow(beauty, hist).numpy())


def _first_sample_bit_equal(fn, need):
    """fn() through the kernels (each of `need` launched), its recorded
    brute-force queries each bit-equal to the plain version, then again
    through the plain versions (nothing launched), bit-equal."""
    from optix_raytracer_tpu_torch.tools.mcv_probe import bf_query_parity
    from optix_raytracer_tpu_torch.tools.whitted_probe import (
        plain_queries, recorded_queries)
    kernels.reset_launches()
    with recorded_queries() as calls:
        out = fn()
    torch.cuda.synchronize()
    assert all(kernels.LAUNCHES[k] > 0 for k in need), kernels.LAUNCHES
    assert calls and all(bf_query_parity(c)["bit_equal"] for c in calls)
    kernels.reset_launches()
    with plain_queries():
        ref = fn()
    assert not any(kernels.LAUNCHES.values())
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    np.testing.assert_array_equal(out, ref)
    assert np.isfinite(out).all() and out.mean() > 0
    return out


def test_motion_engine_matches_plain_and_cpu(cuda):
    """The motion-blur engine scene at 64², 4 samples, depth 2: through
    kernels 1-2 bit-equal to the plain versions, and within the bars of
    the CPU's render (same ray count)."""
    from optix_raytracer_tpu_torch.apps import simple_motion_blur as smb
    runs = {}
    for dev in (cuda, "cpu"):
        scene = smb.engine_scene(dev)
        cam = smb.engine_camera(64, 64).params(dev)

        def launch():
            return engine.render_accumulate(
                scene, cam, Film.create(64, 64, dev), 64, 64,
                samples_per_launch=4, max_depth=2, chunk_size=None)

        if dev == cuda:
            _first_sample_bit_equal(lambda: launch()[0].accum,
                                    ("bf_closest", "bf_any"))
        film, rays = launch()
        runs[str(dev)] = (film.accum.cpu().numpy(), int(rays))
    assert runs["cuda"][1] == runs["cpu"][1]
    torch_parity.assert_image_close(runs["cuda"][0], runs["cpu"][0],
                                    "motion engine")


def test_motion_geometry_matches_plain_and_cpu(cuda):
    """motion_geometry at 64², 2 samples: kernel 1 on the object-space
    rays bit-equal to its plain version, the image within the bars of the
    CPU's."""
    from optix_raytracer_tpu_torch.apps import motion_geometry as mg
    out = _first_sample_bit_equal(
        lambda: mg.render(64, 64, samples=2, device=cuda)[0],
        ("bf_closest",))
    ref = mg.render(64, 64, samples=2, device="cpu")[0].numpy()
    torch_parity.assert_image_close(out, ref, "motion_geometry")


@pytest.mark.parametrize("kind", ["quad", "cubic_bspline", "catmullrom",
                                  "bezier"])
def test_swept_prims_card_matches_cpu(cuda, kind):
    """Swept spans of a random strand: hits on the card against the CPU's
    on the same rays (masks equal, t within rtol 1e-4, normals and uv
    within 1e-3), and in ray chunks of any size."""
    from optix_raytracer_tpu_torch.accel import curves as cv
    from optix_raytracer_tpu_torch.accel import primitives as prim
    rng = np.random.default_rng(len(kind))
    control = np.cumsum(rng.normal(size=(7, 3)) * 0.3 + [0, 0.35, 0],
                        axis=0).astype(np.float32)
    control -= control.mean(axis=0)
    widths = np.linspace(0.12, 0.04, 7).astype(np.float32)
    descs = (cv.strand_to_swept_quads(control, widths) if kind == "quad"
             else cv.strand_to_swept_cubics(control, widths, kind=kind))
    n = 1 << 16
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    tgt = control[rng.integers(0, 7, n)] + rng.normal(size=(n, 3)) * 0.08
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=1, keepdims=True)
    out = {}
    for dev in (cuda, "cpu"):
        rays = Rays.make(torch.as_tensor(o, device=dev),
                         torch.as_tensor(d.astype(np.float32), device=dev),
                         tmin=1e-3, tmax=50.0)
        h = prim.intersect_prims_closest(prim.make_prims(descs, dev), rays)
        out[str(dev)] = {f: getattr(h, f).cpu().numpy()
                         for f in ("prim_id", "t", "normal", "uv")}
    a, b = out["cuda"], out["cpu"]
    np.testing.assert_array_equal(a["prim_id"], b["prim_id"])
    hit = b["prim_id"] >= 0
    assert 0.05 < hit.mean() < 0.95
    np.testing.assert_allclose(a["t"][hit], b["t"][hit], rtol=1e-4)
    np.testing.assert_allclose(a["normal"], b["normal"], atol=1e-3)
    np.testing.assert_allclose(a["uv"], b["uv"], atol=1e-3)


@pytest.mark.parametrize("app", ["curves", "curves_swept", "ribbons",
                                 "hair"])
def test_swept_curve_apps_card_matches_cpu(cuda, app):
    """The curve apps at 64², one sample: the placeholder mesh's queries
    bit-equal through kernels 1-2 and their plain versions, the image
    within the bars (3e-3 for shaded prims) of the CPU's (the hair's from
    the card's camera rays)."""
    from optix_raytracer_tpu_torch.apps import curves, hair, ribbons

    def render(dev):
        if app == "hair":
            return hair.render(64, 64, samples=1, spline="cubic_bspline",
                               swept=True, device=dev)[0]
        if app == "ribbons":
            return ribbons.render(64, 64, samples=1, device=dev)[0]
        return curves.render(64, 64, samples=1, swept=app == "curves_swept",
                             device=dev)[0]

    if app != "hair":
        out = _first_sample_bit_equal(lambda: render(cuda),
                                      ("bf_closest", "bf_any"))
        torch_parity.assert_image_close(out, render("cpu").numpy(), app,
                                        atol=3e-3)
        return
    # the hair on the CPU from the card's camera rays (mcv_probe.crop_rays)
    from optix_raytracer_tpu_torch.tools.mcv_probe import crop_rays
    out = render(cuda).cpu().numpy()
    rays, _ = crop_rays(hair.camera(64, 64).params(cuda), 64, 64, 0, size=64)
    prims, strand_of = hair.build_prims(*hair.procedural_fur(), "cpu",
                                        "cubic_bspline", swept=True)
    ref = hair.sample_radiance(prims, strand_of, "strand_u", rays)
    torch_parity.assert_image_close(out, ref.numpy(), app, atol=3e-3)


def test_volume_engine_matches_plain_and_cpu(cuda):
    """The Cornell cloud at 64², 2 samples, depth 3: the closest, NEE and
    scatter shadow queries through kernels 1-2 bit-equal to the plain
    versions, the image within the bars of the CPU's (same ray count)."""
    from optix_raytracer_tpu_torch.apps import volume_viewer as vv
    runs = {}
    for dev in (cuda, "cpu"):
        scene = vv.engine_scene(dev, res=24)
        cam = cornell_camera(64, 64).params(dev)

        def launch():
            return engine.render_accumulate(
                scene, cam, Film.create(64, 64, dev), 64, 64,
                samples_per_launch=2, max_depth=3, chunk_size=None)

        if dev == cuda:
            _first_sample_bit_equal(lambda: launch()[0].accum,
                                    ("bf_closest", "bf_any"))
        film, rays = launch()
        runs[str(dev)] = (film.accum.cpu().numpy(), int(rays))
    assert runs["cuda"][1] == runs["cpu"][1]
    torch_parity.assert_image_close(runs["cuda"][0], runs["cpu"][0],
                                    "volume engine")


def test_volume_march_and_nanovdb_on_card(cuda, tmp_path):
    """The standalone march at 64² (res 32, 48 steps) on the card within
    the bars of the CPU's, and a .nvdb grid written here loaded onto the
    card equal to the CPU's load."""
    from optix_raytracer_tpu_torch.apps import volume_viewer as vv
    from optix_raytracer_tpu_torch.io import nanovdb
    out = vv.render(64, 64, samples=1, res=32, num_steps=48,
                    device=cuda)[0].cpu().numpy()
    ref = vv.render(64, 64, samples=1, res=32, num_steps=48,
                    device="cpu")[0].numpy()
    torch_parity.assert_image_close(out, ref, "volume march")
    path = str(tmp_path / "g.nvdb")
    dens = vv.load_grid(None, res=32, device="cpu").density.numpy()
    nanovdb.write_nvdb(path, dens, ijk_min=(8, -16, 0),
                       codec=nanovdb.CODEC_ZIP)
    g_card = nanovdb.load_density_grid(path, device=cuda)
    g_cpu = nanovdb.load_density_grid(path, device="cpu")
    assert g_card.density.device.type == "cuda"
    for f in ("density", "lo", "hi"):
        assert torch.equal(getattr(g_card, f).cpu(), getattr(g_cpu, f))


def _bvh_rays(geom, bvh, seed, device):
    """The walk's ray sets on a mesh: bf_rays (a quarter of them dead),
    tie_rays (centroids and vertices: exact ties on a dup mesh, edges) and
    axis-aligned rays starting exactly on node bounds (a zero direction
    component against an origin on a slab plane)."""
    rng = np.random.default_rng(seed)
    lo = bvh.node_lo.cpu().numpy()
    hi = bvh.node_hi.cpu().numpy()
    pick = rng.integers(0, len(lo), 256)
    o = 0.5 * (lo[pick] + hi[pick])
    axis = rng.integers(0, 3, 256)
    o[np.arange(256), axis] = np.where(rng.random(256) < 0.5, lo[pick, axis],
                                       hi[pick, axis])
    d = np.zeros((256, 3), np.float32)
    d[np.arange(256), (axis + 1) % 3] = np.where(rng.random(256) < 0.5, 1.0,
                                                 -1.0)
    o = o - 10.0 * d
    planes = np.concatenate([o, d, np.full((256, 1), 1e-3),
                             np.full((256, 1), 1e16)], axis=1)
    sets = [torch_parity.bf_rays(4099, seed, dead=0.25, geom=geom,
                                 device=device),
            torch_parity.tie_rays(geom, seed, device=device),
            torch_parity.rays8(planes.astype(np.float32), device)]
    return sets


def _walk_equal(bvh, geom, tri_mat, rays):
    """bvh_walk_kernel<true / false> against walk_plain on the card, bit
    for bit, each wrapper counting one launch."""
    from optix_raytracer_tpu_torch.accel import traverse as trav
    before = dict(kernels.LAUNCHES)
    out = trav.walk_closest(bvh, geom.tri_consts, tri_mat, rays)
    occ = trav.walk_any(bvh, geom.tri_consts, rays)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bvh_walk_closest"] == (
        before["bvh_walk_closest"] + 1)
    assert kernels.LAUNCHES["bvh_walk_any"] == before["bvh_walk_any"] + 1
    ref = trav.traverse_plain(bvh, geom, tri_mat, rays)
    for k, r in (("t", ref.t), ("prim_id", ref.prim_id),
                 ("mat_id", ref.mat_id), ("uv", ref.uv),
                 ("normal", ref.normal)):
        assert torch.equal(_bits(out[k]), _bits(r)), k
    assert torch.equal(occ, trav.traverse_plain(bvh, geom, None, rays,
                                                any_hit=True))
    return ref, occ


@pytest.mark.parametrize("tree", ["lbvh", "sah"])
def test_bvh_walk_matches_plain(cuda, tree):
    """The walk kernel (closest and any-hit) against the lock-step loop on
    the card, bit for bit: a 700-triangle random mesh, a duplicated one
    (exact ties) and the knot of 2,402 triangles, on the LBVH built on the
    card and on the native SAH tree."""
    from optix_raytracer_tpu_torch.accel import native
    from optix_raytracer_tpu_torch.accel.lbvh import LBVH, build_lbvh
    verts, idx, _, knot_mat, _ = B.knot_mesh(40, 30)
    meshes = [torch_parity.bf_mesh(700, 3, device=cuda),
              torch_parity.bf_mesh(600, 4, dup=True, device=cuda),
              (build_triangle_geometry(verts, idx, cuda),
               torch.as_tensor(knot_mat, device=cuda))]
    hits = 0
    for seed, (geom, tri_mat) in enumerate(meshes):
        if tree == "lbvh":
            bvh = build_lbvh(geom)
        else:
            arrays = native.build_bvh_sah(geom)
            if arrays is None:
                pytest.skip("no native SAH builder (g++) on this machine")
            bvh = LBVH.from_numpy(arrays, cuda)
        for rays in _bvh_rays(geom, bvh, seed, cuda):
            ref, occ = _walk_equal(bvh, geom, tri_mat, rays)
            hits += int(ref.valid.sum()) + int(occ.sum())
    assert hits > 0


def test_bvh_build_card_equals_cpu(cuda):
    """build_lbvh on the card gives the CPU build's node arrays bit for bit
    (a random mesh and the knot)."""
    from optix_raytracer_tpu_torch.accel.lbvh import build_lbvh
    verts, idx, _, _, _ = B.knot_mesh(40, 30)
    for make in (lambda d: torch_parity.bf_mesh(900, 8, device=d)[0],
                 lambda d: build_triangle_geometry(verts, idx, d)):
        a, b = build_lbvh(make(cuda)), build_lbvh(make("cpu"))
        for f in ("node_lo", "node_hi", "node_skip", "node_prim"):
            assert torch.equal(_bits(getattr(a, f)).cpu(),
                               _bits(getattr(b, f))), f


def test_bvh_walk_dispatch_on_card(cuda, monkeypatch):
    """Past the (lowered) cluster cap a scene with a BVH walks it through
    the kernel, launching no cluster kernel, with the plain loop's hits;
    a BVH that does not fit the geometry raises on the card instead of
    falling back."""
    from optix_raytracer_tpu_torch.accel import traverse as trav
    from optix_raytracer_tpu_torch.accel.lbvh import LBVH
    from optix_raytracer_tpu_torch.scene.device_scene import make_device_scene
    from optix_raytracer_tpu_torch.wavefront import intersect
    monkeypatch.setattr(C, "MAX_SUPERCLUSTERS", 1)
    monkeypatch.setattr(C, "SC_CLUSTERS", 2)
    verts, idx, _, tri_mat, _ = B.knot_mesh(40, 30)
    scene = make_device_scene(verts, idx, tri_mat, B.KNOT_MATERIALS, cuda,
                              with_bvh=True)
    assert scene.has_bvh and not scene.has_clusters
    rays = _bvh_rays(scene.geom, scene.bvh, 5, cuda)[0]
    kernels.reset_launches()
    hits = intersect.scene_closest(scene, rays)
    occ = intersect.scene_any(scene, rays)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bvh_walk_closest"] == 1
    assert kernels.LAUNCHES["bvh_walk_any"] == 1
    assert not any(v for k, v in kernels.LAUNCHES.items()
                   if k.startswith(("cluster", "qwalk", "bf")))
    ref = trav.traverse_plain(scene.bvh, scene.geom, scene.tri_mat, rays)
    assert torch.equal(hits.prim_id, ref.prim_id)
    assert torch.equal(_bits(hits.t), _bits(ref.t))
    assert torch.equal(occ, trav.traverse_plain(scene.bvh, scene.geom, None,
                                                rays, any_hit=True))
    half = LBVH(nodes=scene.bvh.nodes[:-2])
    with pytest.raises(ValueError):
        trav.traverse(half, scene.geom, scene.tri_mat, rays)


def _plain_vs_kernels(fn, names):
    """fn() through the kernels (each of `names` launched) and again with
    every query through the plain versions → (kernel output, plain
    output)."""
    from optix_raytracer_tpu_torch.tools.whitted_probe import plain_queries
    kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    assert all(kernels.LAUNCHES[k] > 0 for k in names), kernels.LAUNCHES
    with plain_queries():
        ref = fn()
    return out, ref


def test_loaded_model_on_card(cuda, tmp_path):
    """s1 at 64²: the knot model's .glb through the meshviewer (kernels
    4-6) bit-equal to the plain versions and to the same arrays added
    through Scene.add_mesh / add_texture; the OBJ through the native
    parser; --animate 3 writes three frames that differ."""
    from optix_raytracer_tpu_torch.apps import meshviewer
    from optix_raytracer_tpu_torch.io.image import load_image
    from optix_raytracer_tpu_torch.scene.scene import Scene
    from optix_raytracer_tpu_torch.tools import model_probe as MP
    glb, obj, meshes, materials, images = MP.knot_files(str(tmp_path))
    assert MP.obj_case(obj, meshes)["triangles"] == 25202
    out, ref = _plain_vs_kernels(
        lambda: meshviewer.render(glb, 64, 64, samples=2, max_depth=3,
                                  device=cuda),
        ("cluster_cull_exact", "cluster_closest", "cluster_any"))
    assert torch.equal(out[0], ref[0]) and int(out[2]) == int(ref[2])
    added = MP.added_scene(meshes, materials, images,
                           Scene.load(glb).cameras[0])
    again = meshviewer.render(None, 64, 64, samples=2, max_depth=3,
                              scene=added, device=cuda)
    assert torch.equal(out[0], again[0]) and float(out[0].mean()) > 0.01
    meshviewer.main(["--model", glb, "--animate", "3", "--samples", "1",
                     "--dim", "64x64", "--file", str(tmp_path / "a.ppm"),
                     "--device", "cuda"])
    frames = [load_image(str(tmp_path / f"a_{i:03d}.ppm")) for i in range(3)]
    assert all(not np.array_equal(a, b) for i, a in enumerate(frames)
               for b in frames[i + 1:])


def test_viewer_on_card(cuda, tmp_path):
    """s2 at 64²: the viewer's film bit-equal to the same render_accumulate
    launches (kernel 3) and to a --checkpoint / --resume split."""
    from optix_raytracer_tpu_torch.apps import viewer
    common = ["--dim", "64x64", "--spf", "2", "--depth", "4", "--device",
              "cuda", "--file", str(tmp_path / "v.ppm")]
    kernels.reset_launches()
    v, _ = viewer.main(common + ["--frames", "4"])
    assert kernels.LAUNCHES["pt_fused_cornell"] == 4
    film = Film.create(64, 64, cuda)
    cam = v.camera.params(cuda)
    for _ in range(4):
        film, _ = engine.render_accumulate(v.scene, cam, film, 64, 64,
                                           samples_per_launch=4, max_depth=4)
    assert torch.equal(film.accum, v.film.accum)
    ck = str(tmp_path / "v.npz")
    viewer.main(common + ["--frames", "2", "--checkpoint", ck])
    v2, _ = viewer.main(common + ["--frames", "2", "--resume", ck])
    assert torch.equal(v2.film.accum, v.film.accum)


def test_instanced_knots_on_card(cuda):
    """s3 at 64²: four instances of the 25k knot walking their per-mesh
    cluster table (kernels 4-6, never the fused kernel), bit-equal to the
    plain versions, and within the parity bars of the same meshes baked
    flat, Whitted and path-traced, with equal ray counts."""
    from optix_raytracer_tpu_torch.apps import meshviewer
    from optix_raytracer_tpu_torch.shade.lights import ParallelogramLight
    from optix_raytracer_tpu_torch.tools import model_probe as MP
    inst, flat = MP.instanced_knot_hosts()
    names = ("cluster_cull_exact", "cluster_closest", "cluster_any")
    out, ref = _plain_vs_kernels(
        lambda: meshviewer.render(None, 64, 64, samples=2, max_depth=3,
                                  scene=inst, device=cuda), names)
    assert not any(k.startswith("pt_fused") and n for k, n in
                   kernels.LAUNCHES.items())
    assert torch.equal(out[0], ref[0]) and int(out[2]) == int(ref[2])
    base = meshviewer.render(None, 64, 64, samples=2, max_depth=3,
                             scene=flat, device=cuda)
    torch_parity.assert_image_close(out[0].cpu().numpy(),
                                    base[0].cpu().numpy(), "s3 whitted")
    assert int(out[2]) == int(base[2])
    light = ParallelogramLight.make(*MP.S3_LIGHT, cuda)
    cam = inst.default_camera(64, 64).params(cuda)
    films = [engine.render_accumulate(
        sc.finalize(cuda, area_light=light), cam, Film.create(64, 64, cuda),
        64, 64, samples_per_launch=4, max_depth=4) for sc in (inst, flat)]
    a, b = (f.accum.cpu().numpy() for f, _ in films)
    bad = ~np.isclose(a, b, atol=2e-3, rtol=1e-3).all(axis=-1)
    assert int(bad.sum()) <= 4 and a.mean() > 0


def test_small_apps_on_card(cuda, tmp_path):
    """s4 at reduced sizes: each app through main() on the card, and the
    kernel-launching ones held against their plain versions."""
    from optix_raytracer_tpu_torch.tools import model_probe as MP
    glb = MP.write_knot_model(str(tmp_path / "k.glb"), 20, 14, 16)[0]
    rows = MP.small_apps_case(cuda, str(tmp_path), glb,
                              dims={k: (64, 48) for k in MP.S4})
    by = {r["app"]: r for r in rows}
    assert by["triangle"]["plain_bit_equal"]
    assert by["raycasting"]["plain_bit_equal"]
    assert by["raycasting --model"]["launches"].get("cluster_closest", 0)
    assert by["console"]["plain_rays_equal"]
    assert by["dynamic_materials"]["launches"].get("pt_fused_cornell", 0)


@pytest.mark.parametrize("spl", [8, 2])
def test_spd_tetra_launch_on_card(cuda, spl):
    """The SPD `tetra` at level 7 (65,538 triangles, 513 clusters) through
    `auto` at 32 x 24, depth 3: spl 8 takes the sample-major strips, spl 2
    the sorted sequential loop; either runs kernels 4 / 5 / 6 and never the
    fused kernel, and matches the benchmark's plain reference at every
    pixel: ray counts equal, film_rel_l1 under 1e-3 (read: 7e-08)."""
    import json
    from pathlib import Path

    from benchmark import check, scenes

    w, h, depth = 32, 24, 3
    cfg = json.loads((Path(__file__).resolve().parents[1]
                      / "benchmark/configs/spd_tetra.json").read_text())
    cfg.update(width=w, height=h, max_depth=depth)
    scene = B.spd_tetra_scene(cuda)
    assert scene.has_clusters and scene.clusters.num_clusters == 513
    cam = B.spd_tetra_camera(w, h).params(cuda)
    kernels.reset_launches()
    film, rays = engine.render_accumulate(
        scene, cam, Film.create(h, w, cuda), w, h, samples_per_launch=spl,
        max_depth=depth)
    torch.cuda.synchronize()
    launched = dict(kernels.LAUNCHES)
    for k in ("cluster_cull_exact", "cluster_closest", "cluster_any"):
        assert launched[k] > 0, k
    assert not any(launched[k] for k in kernels.FUSED_INSTANTIATIONS)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    px, py = xx.reshape(1, -1), yy.reshape(1, -1)
    ref_films, ref_rays = check.reference_films(
        scenes.build(cfg["scene"]), cfg,
        dict(samples_per_launch=spl, film="accumulate"),
        [tuple(cfg["camera"]["eye"])], px, py, cuda)
    values = check.numbers(film.accum.reshape(1, -1, 3).cpu().numpy(),
                           ref_films, int(rays), ref_rays,
                           np.ones_like(px, np.float64))
    print(f"spd tetra spl {spl}: {values}, launches {launched}")
    assert int(ref_rays.sum()) == int(rays)
    assert values["film_rel_l1"] < 1e-3


@pytest.mark.parametrize("spl", [8, 2])
def test_spd_tetra_launch_makes_no_sync(cuda, spl):
    """After two warm-up launches, a cluster launch of the SPD `tetra` (the
    sample-major strips at spl 8, the sorted sequential loop at spl 2, then
    replayed as a CUDA graph, whose capture at the second launch syncs)
    makes no host-device sync (torch.cuda.set_sync_debug_mode("error")):
    `Rays.make` fills the camera rays' tmin / tmax planes on the card."""
    w, h = 64, 48
    scene = B.spd_tetra_scene(cuda)
    cam = B.spd_tetra_camera(w, h).params(cuda)
    film = Film.create(h, w, cuda)
    for _ in range(2):
        film = engine.render_accumulate(scene, cam, film, w, h,
                                        samples_per_launch=spl,
                                        max_depth=3)[0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            film, rays = engine.render_accumulate(scene, cam, film, w, h,
                                                  samples_per_launch=spl,
                                                  max_depth=3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(film.subframe) == 4 * spl and int(rays) > 0


def test_launch_graph_replays_the_eager_loop(cuda, monkeypatch):
    """The sorted sequential loop on the SPD `tetra` (spl 2, depth 3, the
    camera turning each launch, the film kept) replayed as a CUDA graph
    from its third launch (the first, probed, makes no sync): films and ray
    counts bit-equal to the eager loop's (ORT_LAUNCH_GRAPH=0), and the
    counters read the same."""
    from optix_raytracer_tpu_torch.wavefront import launch_graph

    w, h, spl, depth = 64, 48, 2, 3
    base = B.spd_tetra_camera(w, h)

    def launches(graphs):
        monkeypatch.setenv("ORT_LAUNCH_GRAPH", "1" if graphs else "0")
        scene = B.spd_tetra_scene(cuda)
        kernels.reset_launches()
        telemetry.reset_counters("clusters.queries")
        telemetry.reset_counters("engine.graphs")
        film, out = Film.create(h, w, cuda), []
        for k in range(5):
            eye = np.asarray(base.eye) + np.array([0.05 * k, 0.0, 0.0])
            cam = dataclasses.replace(base, eye=tuple(eye)).params(cuda)
            film, rays = engine.render_accumulate(
                scene, cam, film, w, h, samples_per_launch=spl,
                max_depth=depth)
            out.append((film.accum.clone(), int(rays)))
            if graphs and k == 0:
                assert list(scene.launch_graphs.values()) == [
                    launch_graph._SEEN]
        return out, (dict(kernels.LAUNCHES), dict(C.QUERIES),
                     dict(launch_graph.GRAPHS), len(scene.launch_graphs))

    eager, (e_launches, e_queries, e_graphs, e_kept) = launches(False)
    graphed, (g_launches, g_queries, g_graphs, g_kept) = launches(True)
    for (a, ra), (b, rb) in zip(eager, graphed):
        assert ra == rb and torch.equal(a, b)
    assert g_launches == e_launches and g_queries == e_queries
    assert e_graphs == dict(captured=0, replayed=0) and e_kept == 0
    assert g_graphs == dict(captured=1, replayed=3) and g_kept == 1
