"""The fused kernel's group culling and its path-regeneration counts, on the
CPU (accel/tri_groups.py fused_group_boxes, fused_group_admitted_plain;
wavefront/pallas_pt.py fused_group_closest_plain / _any_plain;
tools/bench_fused.py path_lengths and warp_steps).

The rule: a ray tests a group of consecutive triangles only when its slab
test crosses the group's box widened by the walks' admission margin. Held
here: every (ray, triangle) pair that brute force's tri_accept takes lies in
a group the rule admits, on the Cornell box, the smooth knot
`knot_scene(16, 15)` and the textured scene, for random rays, rays that
start on surfaces (tmin 1e-2), the wavefront's own closest and shadow rays
and rays built to graze the group boxes' faces; the culled closest loop
(groups ascending, strict <) gives brute force's ids bit for bit, on rays
through shared edges (exact ties) too, and the JAX package's brute-force ids
on the knot; the per-(pixel, sample) path lengths sum to the engine's ray
count; the variant scenes of the card's parity test take their
instantiation, the small tables whole and the culled ones in groups; the
margin is needed (at 0, rays that graze the boxes lose hits); the group
size is the measured cutoff's; the tool's occupancy arithmetic by hand."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_raytracer_tpu.accel import bruteforce as jbf
from optix_raytracer_tpu.accel.geometry import build_triangle_geometry as jbuild
from optix_raytracer_tpu.core.rays import Rays as JRays
from optix_raytracer_tpu_torch import kernels
from optix_raytracer_tpu_torch.accel import clusters as cluster_mod
from optix_raytracer_tpu_torch.accel import tri_groups as G
from optix_raytracer_tpu_torch.accel.geometry import TriangleGeometry
from optix_raytracer_tpu_torch.accel.pallas_bf import (_accept, _tri_test,
                                                       any_hit_plain,
                                                       closest_hit_plain)
from optix_raytracer_tpu_torch.core.rays import Rays
from optix_raytracer_tpu_torch.scene import builtins as B
from optix_raytracer_tpu_torch.tools import bench_fused as BF
from optix_raytracer_tpu_torch.wavefront import engine
from optix_raytracer_tpu_torch.wavefront import pallas_pt as P

CPU = torch.device("cpu")
# Group sizes held per scene: fused_group_size's 8, the sizes 4 and 16
# the cutoff table also timed, and 32 on the knot; the textured scene's 4
# triangles in
# groups of 1 and 2 (the kernel tests them as one group).
GROUPS = dict(cornell=(4, 8, 16), knot=(8, 16, 32), textured=(1, 2))


def _scene(name):
    if name == "cornell":
        return B.cornell_box(CPU), B.cornell_camera, 4
    if name == "knot":
        return B.knot_scene(16, 15, device=CPU), B.knot_camera, 3
    return (B.textured_scene(CPU, (32, 16, 16, 8), 0.6, 0.8),
            B.textured_camera, 3)


@pytest.fixture(scope="module")
def scenes():
    return {name: _scene(name) for name in GROUPS}


def _cols(o, d):
    return ([o[:, k:k + 1] for k in range(3)]
            + [d[:, k:k + 1] for k in range(3)])


def _unit(d):
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _random_rays(geom, seed, n=1500):
    """Origins in the scene's box grown by a half, unit directions, the
    camera's tmin 1e-4."""
    rng = np.random.default_rng(seed)
    v = geom.v0.numpy()
    lo, hi = v.min(0), v.max(0)
    pad = 0.5 * (hi - lo)
    o = rng.uniform(lo - pad, hi + pad, (n, 3)).astype(np.float32)
    d = _unit(rng.normal(size=(n, 3))).astype(np.float32)
    return o, d, np.full(n, 1e-4, np.float32), np.full(n, 1e16, np.float32)


def _surface_rays(geom, seed, n=1500):
    """Rays that start on a triangle (v0 + u e1 + v e2) with the bounce and
    shadow rays' tmin 1e-2; half of them run to a finite tmax."""
    rng = np.random.default_rng(seed)
    m = geom.num_triangles
    t = rng.integers(0, m, n)
    u = rng.uniform(0, 1, n)
    v = rng.uniform(0, 1, n) * (1 - u)
    o = (geom.v0.numpy()[t] + u[:, None] * geom.e1.numpy()[t]
         + v[:, None] * geom.e2.numpy()[t]).astype(np.float32)
    d = _unit(rng.normal(size=(n, 3))).astype(np.float32)
    tmax = np.where(rng.integers(0, 2, n) > 0, 1e16,
                    rng.uniform(0.1, 3.0, n)).astype(np.float32)
    return o, d, np.full(n, 1e-2, np.float32), tmax


def _grazing_rays(geom, boxes, group, seed, reps=24):
    """Rays that graze the group boxes: in a face's plane (that axis's
    direction +0.0 or -0.0), through corners and edges, at the vertex that
    sets a face, axis-parallel along a face, and windows that end on a
    face; tmin 1e-2 on half of them."""
    rng = np.random.default_rng(seed)
    b = boxes.numpy()
    v0 = geom.v0.numpy()
    corners = np.stack([v0, v0 + geom.e1.numpy(), v0 + geom.e2.numpy()], 1)
    m = geom.num_triangles
    out = []

    def add(o, d, tmax=1e16):
        tmin = 1e-2 if rng.integers(2) else 1e-4
        out.append(np.concatenate([o, d, [tmin, tmax]]).astype(np.float32))

    for g in range(b.shape[0]):
        lo, hi = b[g, 0:3], b[g, 3:6]
        ext = float((hi - lo).max())
        vs = corners[g * group:min(m, (g + 1) * group)].reshape(-1, 3)
        for _ in range(reps):
            a = rng.integers(3)
            low = bool(rng.integers(2))
            face = (lo if low else hi)[a]
            p = rng.uniform(lo, hi).astype(np.float32)
            p[a] = face
            dist = np.float32(rng.uniform(0.5, 3.0) * ext)
            d = _unit(rng.normal(size=3)).astype(np.float32)
            d[a] = -0.0 if rng.integers(2) else 0.0
            d = _unit(d).astype(np.float32)
            d[a] = -0.0 if rng.integers(2) else 0.0
            o = (p - d * dist).astype(np.float32)
            o[a] = face
            add(o, d, rng.choice([1e16, dist]))
            q = np.where(rng.integers(2, size=3) > 0, lo, hi).astype(
                np.float32)
            d = _unit(rng.normal(size=3)).astype(np.float32)
            add((q - d * dist).astype(np.float32), d)
            vert = vs[np.argmin(vs[:, a]) if low else np.argmax(vs[:, a])]
            d = _unit(rng.normal(size=3)).astype(np.float32)
            add((vert - d * dist).astype(np.float32), d,
                rng.choice([1e16, dist]))
            d = np.array([-0.0 if rng.integers(2) else 0.0
                          for _ in range(3)], np.float32)
            c = (a + 1 + rng.integers(2)) % 3
            d[c] = 1.0 if rng.integers(2) else -1.0
            o = rng.uniform(lo, hi).astype(np.float32)
            o[a] = face
            o[c] = (lo[c] - dist) if d[c] > 0 else (hi[c] + dist)
            add(o, d)
            o = (p + _unit(rng.normal(size=3)) * dist).astype(np.float32)
            d = _unit(p - o).astype(np.float32)
            if d[a] != 0:
                add(o, d, np.float32((face - o[a]) / d[a]))
    r = np.stack(out)
    return r[:, 0:3], r[:, 3:6], r[:, 6], r[:, 7]


def _wavefront_rays(scene, camera, depth):
    """The closest and shadow rays of one 24x16 sample of the wavefront
    (recorded as tools/bench_fused.py records them), live ones only."""
    closest, shadow, _ = BF.record_queries(engine, scene,
                                        camera(24, 16).params(CPU), 24, 16,
                                        depth)
    r = [x.reshape(x.tmin.numel()) for x in closest + shadow]
    o = torch.cat([x.origin for x in r])
    d = torch.cat([x.direction for x in r])
    tmin = torch.cat([x.tmin for x in r])
    tmax = torch.cat([x.tmax for x in r])
    live = tmax > tmin
    return (o[live].numpy(), d[live].numpy(), tmin[live].numpy(),
            tmax[live].numpy())


def _rays(kind, scene, camera, depth, boxes, group, seed=3):
    if kind == "random":
        return _random_rays(scene.geom, seed)
    if kind == "surface":
        return _surface_rays(scene.geom, seed)
    if kind == "wavefront":
        return _wavefront_rays(scene, camera, depth)
    return _grazing_rays(scene.geom, boxes, group, seed)


@pytest.mark.parametrize("kind", ["random", "surface", "wavefront",
                                  "grazing"])
@pytest.mark.parametrize("name", list(GROUPS))
def test_accepted_pairs_lie_in_admitted_groups(scenes, name, kind):
    """Every pair brute force's tri_accept takes, on the ray's own window,
    lies in a group whose widened box the ray's slab test crosses."""
    scene, camera, depth = scenes[name]
    tri = scene.geom.tri_consts
    taken = 0
    for group in GROUPS[name]:
        boxes = G.fused_group_boxes(scene.geom, group)
        assert boxes.shape == (-(-scene.num_triangles // group), G.BOX_COLS)
        o, d, tmin, tmax = (torch.as_tensor(x) for x in _rays(
            kind, scene, camera, depth, boxes, group))
        tt, uu, vv, dpz = _tri_test(tri, *_cols(o, d))
        acc = _accept(tt, uu, vv, dpz, tmin[:, None], tmax[:, None])
        adm = G.fused_group_admitted_plain(o, d, tmin, tmax, boxes)
        group_of = torch.arange(scene.num_triangles) // group
        dropped = acc & ~adm[:, group_of]
        assert int(dropped.sum()) == 0, (group, int(dropped.sum()))
        taken += int(acc.sum())
        # the rule drops work: not every group is admitted
        assert int(adm.sum()) < adm.numel()
    assert taken > 0


def _edge_rays(geom, seed=5, n=600):
    """Rays from outside aimed at points of triangle edges (an edge's
    midpoint and its vertices), where adjacent triangles give equal t."""
    rng = np.random.default_rng(seed)
    m = geom.num_triangles
    t = rng.integers(0, m, n)
    w = rng.choice([0.0, 0.5, 1.0], n)
    e = np.where((rng.integers(0, 2, n) > 0)[:, None], geom.e1.numpy()[t],
                 geom.e2.numpy()[t])
    p = geom.v0.numpy()[t] + w[:, None] * e
    d = _unit(rng.normal(size=(n, 3))).astype(np.float32)
    o = (p - 4.0 * d).astype(np.float32)
    return o, d, np.full(n, 1e-4, np.float32), np.full(n, 1e16, np.float32)


@pytest.mark.parametrize("name", list(GROUPS))
def test_culled_loops_give_brute_force_ids(scenes, name):
    """The culled closest loop's ids and t, and the culled shadow loop's
    occlusion, equal brute force's bit for bit, on random, surface and
    edge rays; edge rays give exact ties, which the lowest index wins."""
    scene, camera, depth = scenes[name]
    tri = scene.geom.tri_consts
    ties = 0
    for parts in (_random_rays(scene.geom, 1), _surface_rays(scene.geom, 2),
                  _edge_rays(scene.geom)):
        o, d, tmin, tmax = (torch.as_tensor(x) for x in parts)
        rays = Rays(origin=o, direction=d, tmin=tmin, tmax=tmax)
        ref = closest_hit_plain(tri, scene.tri_mat, rays)
        occ = any_hit_plain(tri, rays)
        tt, uu, vv, dpz = _tri_test(tri, *_cols(o, d))
        acc = _accept(tt, uu, vv, dpz, tmin[:, None], tmax[:, None])
        best = torch.where(acc, tt, torch.inf).amin(dim=1, keepdim=True)
        ties += int(((acc & (tt == best)).sum(dim=1) > 1).sum())
        for group in GROUPS[name]:
            boxes = G.fused_group_boxes(scene.geom, group)
            t, pid, tests = P.fused_group_closest_plain(tri, boxes, group, o,
                                                        d, tmin, tmax)
            np.testing.assert_array_equal(pid.numpy(),
                                          ref["prim_id"].numpy())
            np.testing.assert_array_equal(t.numpy(), ref["t"].numpy())
            o_g, a_tests = P.fused_group_any_plain(tri, boxes, group, o, d,
                                                   tmin, tmax)
            np.testing.assert_array_equal(o_g.numpy(), occ.numpy())
            assert int(tests.max()) <= scene.num_triangles
            assert int(a_tests.max()) <= scene.num_triangles
    if name != "textured":
        assert ties > 0


def test_culled_closest_matches_jax_brute_force():
    """On the smooth knot's mesh handed over from the JAX package's
    geometry (its tri_consts, v0, e1, e2): the culled closest loop's ids
    equal the JAX package's brute-force ids (impl="xla")."""
    verts, idx, _ = B.trefoil_mesh(16, 15)
    jgeom = jbuild(verts, idx)
    geom = TriangleGeometry(
        tri_consts=torch.as_tensor(np.array(jgeom.tri_consts)),
        face_normal=torch.as_tensor(np.array(jgeom.face_normal)),
        valid=torch.as_tensor(np.array(jgeom.valid)),
        v0=torch.as_tensor(np.array(jgeom.v0)),
        e1=torch.as_tensor(np.array(jgeom.e1)),
        e2=torch.as_tensor(np.array(jgeom.e2)))
    o, d, tmin, tmax = _surface_rays(geom, 11)
    ref = jbf.intersect_closest(
        jgeom, JRays(origin=jnp.asarray(o), direction=jnp.asarray(d),
                     tmin=jnp.asarray(tmin), tmax=jnp.asarray(tmax)),
        impl="xla", chunk_size=None)
    hit = np.asarray(ref.valid)
    assert hit.sum() > 100
    for group in (8, 16):
        boxes = G.fused_group_boxes(geom, group)
        t, pid, _ = P.fused_group_closest_plain(
            geom.tri_consts, boxes, group, *(torch.as_tensor(x)
                                             for x in (o, d, tmin, tmax)))
        np.testing.assert_array_equal(pid.numpy(), np.asarray(ref.prim_id))
        # XLA on the CPU contracts products and sums into FMAs; t of a ray
        # that starts on a surface carries its origin's rounding, so the bar
        # is absolute as well as relative
        np.testing.assert_allclose(t.numpy()[hit], np.asarray(ref.t)[hit],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["cornell", "knot"])
def test_path_lengths_sum_to_the_ray_count(scenes, name):
    """bench_fused.path_lengths' per-sample rays sum to the wavefront
    launch's rays_traced; a path has at most max_depth segments; the warp
    steps of the regenerating schedule are at most the lock-step ones; the
    engine's bounce is put back."""
    scene, camera, depth = scenes[name]
    w, h, spl = 16, 12, 2
    cam = camera(w, h).params(CPU)
    bounce = engine._bounce
    seg, rays = BF.path_lengths(scene, cam, w, h, 3, spl, depth)
    assert engine._bounce is bounce
    _, count = engine.render_sum_wavefront(scene, cam, w, h, 3, spl, depth)
    assert seg.shape == (spl, w * h) and rays.shape == (spl,)
    assert int(rays.sum()) == int(count)
    assert int(seg.max()) <= depth and int(seg.min()) >= 1
    steps = BF.warp_steps(seg)
    assert steps["lane_steps"] == int(seg.sum())
    assert steps["regen"] <= steps["lockstep"]


def test_warp_steps_by_hand():
    """Two samples of four lanes in warps of two: lock-step pays per sample
    the longest path of each warp (3 + 4, then 2 + 1), regeneration each
    warp's largest per-lane total (5 + 4); the kernel's 8x4 tiles order
    the lanes of a 16x8 frame by rows of 8 pixels."""
    seg = torch.tensor([[1, 3, 0, 4], [2, 2, 1, 0]])
    steps = BF.warp_steps(seg, warp=2)
    assert steps["lockstep"] == 10 and steps["regen"] == 9
    assert steps["lane_steps"] == 13
    assert steps["regen_lane_eff"] == 13 / 18
    order = BF.warp_order(16, 8, tiled=True).reshape(-1, 32)
    assert order.shape == (4, 32)
    np.testing.assert_array_equal(order[0, :9].numpy(),
                                  [0, 1, 2, 3, 4, 5, 6, 7, 16])
    np.testing.assert_array_equal(order[1, :2].numpy(), [8, 9])
    assert sorted(order.reshape(-1).tolist()) == list(range(128))


@pytest.mark.parametrize("name", [
    kernels.pt_fused_name(sp, pb, pr, g) for g in kernels.GEOMETRY
    for sp in (False, True) for pb in (False, True) for pr in (False, True)])
def test_fused_variant_scenes_take_their_instantiation(name):
    """builtins.fused_variant_scene (the card's parity test of all 32
    instantiations and bench_fused.py --mixes, which test its table whole)
    builds, for each instantiation, a scene the fused kernel takes with
    that instantiation, its table smaller than the culled scenes'."""
    scene, camera = B.fused_variant_scene(name, CPU)
    assert kernels.pt_fused_name(*P.fused_variant(scene)) == name
    scene.require_supported()
    assert scene.num_triangles <= 98
    assert camera(8, 8) is not None


@pytest.mark.parametrize("name", [
    kernels.pt_fused_name(sp, pb, pr, g) for g in kernels.GEOMETRY
    if g != P.INST
    for sp in (False, True) for pb in (False, True) for pr in (False, True)])
def test_culled_variant_scenes_are_culled(name):
    """fused_variant_scene(culled=True) gives each instantiation outside
    instances a scene the kernel takes with that instantiation and whose
    table it cuts into groups."""
    scene, _ = B.fused_variant_scene(name, CPU, culled=True)
    assert kernels.pt_fused_name(*P.fused_variant(scene)) == name
    scene.require_supported()
    assert P.fused_group_size(scene) < scene.num_triangles


def test_gridded_textured_scene_keeps_its_surfaces():
    """textured_scene(grid=8) cuts the two quads into 256 triangles that
    the camera's rays hit where they hit the 4 of grid=1, at the same t,
    with the same uv density."""
    one = B.textured_scene(CPU, (32, 16, 16, 8), 0.6, 0.8, maps="base")
    cut = B.textured_scene(CPU, (32, 16, 16, 8), 0.6, 0.8, maps="base",
                           grid=8)
    assert cut.num_triangles == 4 * 8 * 8
    from optix_raytracer_tpu_torch.core.camera import generate_rays
    rays = generate_rays(B.textured_camera(24, 16).params(CPU), 24, 16,
                         jitter=False)[0].reshape(24 * 16)
    a = closest_hit_plain(one.geom.tri_consts, one.tri_mat, rays)
    b = closest_hit_plain(cut.geom.tri_consts, cut.tri_mat, rays)
    hit = (a["prim_id"] >= 0).numpy()
    np.testing.assert_array_equal(hit, (b["prim_id"] >= 0).numpy())
    assert hit.mean() > 0.5
    np.testing.assert_allclose(b["t"].numpy()[hit], a["t"].numpy()[hit],
                               rtol=1e-5)
    np.testing.assert_allclose(
        cut.geom.uv_density.numpy(),
        np.repeat(one.geom.uv_density.numpy(), 64), rtol=1e-5)


def test_blocks_per_sm_by_hand():
    """bench_fused.blocks_per_sm on the Cornell instantiation's shared
    memory (fused_smem): 78 registers give 25 warps' registers, 6 blocks
    of 4 warps; 85 give 23, 5 blocks; 128 give 16, 4 blocks; 100 KB of
    shared memory a block leaves 2."""
    smem = BF.fused_smem("flat", 32, 0, 8, 0, 32)
    assert smem == 4 * (16 * 40 + 48)
    assert [BF.blocks_per_sm(r, smem) for r in (78, 85, 128)] == [6, 5, 4]
    assert BF.blocks_per_sm(32, 100 * 1024) == 2
    assert BF.fused_smem("smooth", 482, 0, 2, 0, 8) == 4 * (
        16 * 484 + 48 + 8 * 61)
    assert BF.fused_smem("inst", 22, 0, 8, 3, 8) == 4 * (
        16 * 33 + 48) + 8 * 3


@pytest.mark.parametrize("name", list(GROUPS))
def test_margin_is_needed(scenes, name, monkeypatch):
    """On rays that graze the unwidened group boxes, some pair brute
    force's tri_accept takes lies outside every box the ray's slab test
    crosses once the margin is 0, and the culled closest loop then loses
    a hit brute force makes; with the stated margin (the walks',
    extent * 2^-6 + magnitude * 2^-14) no pair is dropped and the ids are
    brute force's."""
    scene, _, _ = scenes[name]
    tri = scene.geom.tri_consts
    group = GROUPS[name][0]
    wide = G.fused_group_boxes(scene.geom, group)
    monkeypatch.setattr(cluster_mod, "SC_MARGIN_REL", 0.0)
    monkeypatch.setattr(cluster_mod, "SC_MARGIN_FLOOR", 0.0)
    narrow = G.fused_group_boxes(scene.geom, group)
    assert bool((narrow[:, 0:3] > wide[:, 0:3]).all())
    o, d, tmin, tmax = (torch.as_tensor(np.concatenate(x)) for x in zip(*(
        _grazing_rays(scene.geom, narrow, group, seed) for seed in range(2))))
    tt, uu, vv, dpz = _tri_test(tri, *_cols(o, d))
    acc = _accept(tt, uu, vv, dpz, tmin[:, None], tmax[:, None])
    group_of = torch.arange(scene.num_triangles) // group
    ref = closest_hit_plain(tri, scene.tri_mat,
                            Rays(origin=o, direction=d, tmin=tmin, tmax=tmax))
    dropped, lost = {}, {}
    for key, boxes in (("stated", wide), ("zero", narrow)):
        adm = G.fused_group_admitted_plain(o, d, tmin, tmax, boxes)
        dropped[key] = int((acc & ~adm[:, group_of]).sum())
        _, pid, _ = P.fused_group_closest_plain(tri, boxes, group, o, d,
                                                tmin, tmax)
        lost[key] = int((pid != ref["prim_id"]).sum())
    assert dropped["stated"] == 0 and lost["stated"] == 0
    assert dropped["zero"] > 0 and lost["zero"] > 0


# Tables below, at and above the measured cutoff: the prims scene (2
# triangles), the textured scene (4), knot_scene(2, 2) (10), the Cornell
# box (32), knot_scene(4, 4) (34), knot_scene(4, 8) without normals (66),
# the textured scene cut into 4 x 4 cells (64), knot_scene(8, 12) (194),
# the smooth knot (482); their group sizes.
def _cutoff_scenes():
    return [(B.prims_scene(CPU), 2),
            (B.textured_scene(CPU, (32, 16, 16, 8), 0.6, 0.8), 4),
            (B.knot_scene(2, 2, device=CPU), 8), (B.cornell_box(CPU), 8),
            (B.knot_scene(4, 4, device=CPU), 8),
            (B.knot_scene(4, 8, device=CPU, smooth=False), 8),
            (B.textured_scene(CPU, (32, 16, 16, 8), 0.6, 0.8, grid=4), 8),
            (B.knot_scene(8, 12, device=CPU), 8),
            (B.knot_scene(16, 15, device=CPU), 8)]


def test_group_size_is_the_measured_cutoff():
    """fused_group_size: a table below FUSED_CULL_MIN_TRIS triangles (the
    cutoff measured on the H100, PERF.md §6) is tested whole (group ==
    m); from the cutoff on it is culled (group < m) in groups of
    FUSED_GROUP, whatever its size or geometry mode; an instanced scene
    is tested whole whatever its size."""
    assert (G.FUSED_CULL_MIN_TRIS, G.FUSED_GROUP) == (10, 8)
    sizes = []
    for scene, want in _cutoff_scenes():
        m = scene.num_triangles
        g = P.fused_group_size(scene)
        sizes.append(m)
        assert g == want, (m, g)
        assert (g < m) == (m >= G.FUSED_CULL_MIN_TRIS), (m, g)
    assert sizes == [2, 4, 10, 32, 34, 66, 64, 194, 482]
    inst = B.cornell_box_instanced(CPU)
    assert P.fused_group_size(inst) == inst.num_triangles
