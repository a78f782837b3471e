"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked `gpu`; every test skips when `torch.cuda.is_available()` is false
(decided in a fixture, never at import). Run on a CUDA machine with
`python -m pytest tests/test_torch_gpu.py -m gpu`. Bars: hit ids and
occlusion equal, t within rtol 1e-5, uv 1e-4, normals 1e-5
(test_pallas_intersect.py); the exact cull's tables bit-equal; ray counts
equal and radiance within atol 2e-3 / rtol 1e-3 (test_fused_kernel.py)."""
import numpy as np
import pytest
import torch

from optix_raytracer_tpu_torch import kernels
from optix_raytracer_tpu_torch.accel import clusters as C
from optix_raytracer_tpu_torch.accel import pallas_bf
from optix_raytracer_tpu_torch.accel.geometry import build_triangle_geometry
from optix_raytracer_tpu_torch.core.film import Film
from optix_raytracer_tpu_torch.core.rays import Rays
from optix_raytracer_tpu_torch.scene.builtins import (cornell_box,
                                                     cornell_camera,
                                                     knot_camera, knot_scene)
from optix_raytracer_tpu_torch.wavefront import engine, pallas_pt

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


@pytest.mark.parametrize("num_tris", [40, 700])   # 700 spans three tiles
def test_bf_kernels_match_plain(cuda, num_tris):
    geom, tri_mat, rays = _mesh_and_rays(num_tris, 1500, 7, cuda)
    out = pallas_bf.closest_hit(geom.tri_consts, tri_mat, rays)
    ref = pallas_bf.closest_hit_plain(geom.tri_consts, tri_mat, rays)
    torch.cuda.synchronize()
    for k in ("prim_id", "mat_id"):
        np.testing.assert_array_equal(out[k].cpu().numpy(),
                                      ref[k].cpu().numpy())
    hit = ref["prim_id"].cpu().numpy() >= 0
    assert hit.any() and (~hit).any()
    for k, tol in (("t", dict(rtol=1e-5)), ("uv", dict(atol=1e-4)),
                   ("normal", dict(atol=1e-5))):
        np.testing.assert_allclose(out[k].cpu().numpy()[hit],
                                   ref[k].cpu().numpy()[hit], **tol)
    np.testing.assert_array_equal(
        pallas_bf.any_hit(geom.tri_consts, rays).cpu().numpy(),
        pallas_bf.any_hit_plain(geom.tri_consts, rays).cpu().numpy())


def test_bf_wrappers_check_arguments(cuda):
    geom, tri_mat, rays = _mesh_and_rays(8, 64, 1, cuda)
    with pytest.raises(TypeError):
        pallas_bf.closest_hit(geom.tri_consts, tri_mat.long(), rays)
    bad = Rays(rays.origin.double(), rays.direction, rays.tmin, rays.tmax)
    with pytest.raises(TypeError):
        pallas_bf.any_hit(geom.tri_consts, bad)


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


@pytest.mark.parametrize("exact,gate,segments,sides",
                         [(False, False, 20, 14), (True, False, 20, 14),
                          (True, True, 20, 14), (True, True, 512, 125)])
def test_cluster_kernels_match_plain(cuda, exact, gate, segments, sides):
    """Kernels 4-6 against their plain versions on the same inputs; the
    128,002-triangle knot has 1,001 clusters, the resident tier's c_pad of
    1024 (four clusters per cull thread)."""
    cl = knot_scene(segments, sides, device=cuda).clusters
    rays = _knot_rays(20000, 5, cuda)
    n = rays.tmin.shape[0]
    packed = C._pack_rays(rays, C._padded(n))
    nb, c_pad = packed.shape[0] // C.SUB, cl.c_pad
    if exact:
        before = kernels.LAUNCHES["cluster_cull_exact"]
        tn, gm = C.exact_cull(cl.aabb, packed, nb, c_pad)
        assert kernels.LAUNCHES["cluster_cull_exact"] == before + 1
        tn_p, gm_p = C.exact_cull_plain(cl.aabb, packed, nb, c_pad)
        assert torch.equal(tn.view(torch.int32), tn_p.view(torch.int32))
        assert torch.equal(gm, gm_p)
    counts, lists, tnear = C._cull(cl, packed, nb // C.GROUPS, c_pad,
                                   exact=exact)
    args = (counts, lists, tnear, cl.comp, packed, gate)
    rows, rows_p = C.walk_closest(*args), C.walk_closest_plain(*args)
    live = torch.repeat_interleave(counts.reshape(-1) > 0, C.SUB)[:n]
    _assert_hits_equal(C._hits_from_rows(rows[:n], live, rays.tmax),
                       C._hits_from_rows(rows_p[:n], live, rays.tmax))
    occ, occ_p = C.walk_any(*args), C.walk_any_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(occ, occ_p) and 0 < int(occ.sum()) < n


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


@pytest.mark.parametrize("exact,members,segments,sides",
                         [(False, 32, 90, 50), (True, 32, 90, 50),
                          (True, 2, 20, 14)])
def test_sc_kernels_match_plain(cuda, monkeypatch, exact, members, segments,
                                sides):
    """Kernels 5c / 6c against their plain versions on the same lists: rows
    bit-equal, occlusion equal. The 9,002-triangle knot is 3 superclusters
    of the real 32 members; the small knot 3 of 2."""
    cl = _sc_tier(monkeypatch, members, segments, sides, cuda)
    rays = _knot_rays(20000, 5, cuda)
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
    assert torch.equal(occ, occ_p) and 0 < int(occ.sum()) < n
    live = torch.repeat_interleave(counts.reshape(-1) > 0, C.SUB)[:n]
    hits = C._hits_from_rows(rows[:n], live, rays.tmax)
    assert (hits.prim_id >= 0).any() and (hits.prim_id < 0).any()


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


@pytest.mark.parametrize("segments,sides", [(20, 14), (512, 125)])
def test_qwalk_kernels_match_plain(cuda, segments, sides):
    """Kernel 7's octet masks and kernel 8's candidate columns (closest and
    any-hit) against their plain versions on the same work list, bit-equal;
    the 128,002-triangle knot has 1,001 clusters (four per cull thread)."""
    from optix_raytracer_tpu_torch.accel import qwalk as Q
    cl = knot_scene(segments, sides, device=cuda).clusters
    rays = _knot_rays(20000, 5, cuda)
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
    for closest in (True, False):
        out = Q._run_queue(closest, cl.comp, live, qrays)
        plain = (Q.queue_closest_plain if closest else Q.queue_any_plain)(
            live, qrays, cl.comp)
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int32), plain.view(torch.int32))
        hit = out[6] >= 0 if closest else out[0] > 0
        assert 0 < int(hit.sum()) < out.shape[1]
    for name in ("qwalk_oct_cull", "qwalk_closest", "qwalk_any"):
        assert kernels.LAUNCHES[name] == before[name] + 1


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


def _smooth_quad(mats, tri_mat, device):
    """tests/test_fused_textures.py:115-134's smooth quad (a floor with up
    normals, a tilted quad with leaning vertex normals) with the given
    materials, and its camera."""
    from optix_raytracer_tpu_torch.core.camera import Camera
    from optix_raytracer_tpu_torch.scene.device_scene import make_device_scene
    from optix_raytracer_tpu_torch.shade.lights import ParallelogramLight
    s = 3.0
    verts = np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s],
                      [-1, 0, -0.5], [1, 0, -0.5],
                      [1, 1.6, -0.5], [-1, 1.6, -0.5]], np.float32)
    idx = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7]], np.int32)
    normals = np.zeros((8, 3), np.float32)
    normals[:4] = (0, 1, 0)
    nr = np.array([0.3, 0.2, -0.93], np.float32)
    normals[4:] = nr / np.linalg.norm(nr)
    light = ParallelogramLight.make((-1.0, 3.0, -1.0), (2, 0, 0), (0, 0, 2),
                                    (8.0, 8.0, 8.0), device)
    scene = make_device_scene(verts, idx, np.asarray(tri_mat, np.int32), mats,
                              device, area_light=light, normals=normals)
    return scene, lambda w, h: Camera(eye=(0, 1.5, -4.5), lookat=(0, 0.6, 0),
                                      up=(0, 1, 0), fov_y=45.0, aspect=w / h)


def _variant_scene(name, device):
    """A scene per instantiation <geometry, specular, pbr, prims> of the
    fused kernel (kernels.pt_fused_name) and its camera: the bench's prims
    scene with and without glass, the PBR and mirror Cornell boxes, mixes,
    the instanced Cornell, the instanced cube with prims, the small smooth
    knot and the smooth quad with PBR or glass."""
    import dataclasses
    from optix_raytracer_tpu_torch.accel import primitives as prim
    from optix_raytracer_tpu_torch.core.camera import Camera
    from optix_raytracer_tpu_torch.scene import builtins as B
    from optix_raytracer_tpu_torch.scene.device_scene import make_device_scene
    from optix_raytracer_tpu_torch.shade import materials as M
    from optix_raytracer_tpu_torch.shade.lights import ParallelogramLight
    from torch_parity import instanced_cube
    rough = {"kind": M.PBR, "base_color": (0.7, 0.7, 0.6), "metallic": 0.6,
             "roughness": 0.4}
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
    if name == "pt_fused_smooth_pbr":
        return _smooth_quad([rough], [0, 0, 0, 0], device)
    if name == "pt_fused_smooth_specular":
        return _smooth_quad([{"kind": M.DIFFUSE, "base_color": (0.7, 0.5,
                                                                0.4)},
                             {"kind": M.GLASS, "base_color": (0.95, 0.95,
                                                              0.95),
                              "ior": 1.5}], [0, 0, 1, 1], device)
    if name in ("pt_fused_prims", "pt_fused_specular_prims",
                "pt_fused_pbr_prims", "pt_fused_specular_pbr_prims"):
        glass = "specular" in name
        mats = [dict(m) for m in B.PRIMS_MATERIALS]
        if "pbr" in name:
            mats[0] = rough
        if not glass:
            mats = mats[:3]
        verts, idx = B.prims_floor()
        scene = make_device_scene(
            verts, idx, np.zeros(2, np.int32), mats, device,
            area_light=ParallelogramLight.make(*B.PRIMS_LIGHT, device),
            prims=prim.make_prims(B.prims_list(glass), device))
        return scene, B.prims_camera
    mats = B.pbr_cornell_materials(*((1.0, 0.02) if name == "pt_fused_specular"
                                     else (0.8, 0.35)))
    if name == "pt_fused_specular_pbr":
        mats[B.GREEN] = {"kind": M.GLASS, "base_color": (0.9, 1.0, 0.9),
                         "ior": 1.45}
        mats[B.RED] = {"kind": M.PBR, "base_color": (0.9, 0.2, 0.2),
                       "metallic": 1.0, "roughness": 0.0}
    verts, idx, tri_mat = B.quads_to_triangles(B._CORNELL_QUADS)
    light = ParallelogramLight.make(B.CORNELL_LIGHT_CORNER, B.CORNELL_LIGHT_V1,
                                    B.CORNELL_LIGHT_V2,
                                    B.CORNELL_LIGHT_EMISSION, device)
    return (make_device_scene(verts, idx, tri_mat, mats, device,
                              area_light=light), B.cornell_camera)


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
