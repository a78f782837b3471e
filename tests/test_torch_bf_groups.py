"""Group culling of the brute-force kernels (1 and 2, `csrc/bf.cu`) in its
plain form, on the CPU: `pallas_bf.closest_hit_groups_plain` /
`any_hit_groups_plain`, the kernels' culled loops at their interface, with
the group boxes of `accel/tri_groups.py` (`bf_group_boxes`: groups of
FUSED_GROUP triangles from FUSED_CULL_MIN_TRIS on, the table whole below).

Held here: the culled loops give `closest_hit_plain`'s ids, t, uv and
normals and `any_hit_plain`'s occlusion bit for bit on random meshes of
m in {1, 9, 10, 31, 32, 33, 257, 482, 700} triangles with half their lanes
dead, on a table of duplicated triangles and rays through shared edges
(exact ties), on the cull's edge-case rays (`torch_parity.cull_edge_rays`
on the group boxes, widened and not), on the walks' lone grazing rays
(`torch_parity.lone_gated_rays` on knot_scene(20, 14)) and on the instanced
Cornell box's slices; on 16x16 Cornell camera rays the culled closest hit
equals the JAX package's Pallas kernel (interpret mode); a scene builds its
boxes once and the queries pass them. The same sets on the card:
tests/test_torch_gpu.py::test_bf_kernels_*. Torch on one thread; about
25 s on one worker.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_raytracer_tpu.accel import pallas_bf as jpbf
from optix_raytracer_tpu.core.rays import Rays as JRays
from optix_raytracer_tpu.scene.builtins import cornell_box as jcornell
from optix_raytracer_tpu_torch.accel import pallas_bf as P
from optix_raytracer_tpu_torch.accel import tlas
from optix_raytracer_tpu_torch.accel import tri_groups as G
from optix_raytracer_tpu_torch.core import rng as trng
from optix_raytracer_tpu_torch.core.camera import generate_rays
from optix_raytracer_tpu_torch.scene import builtins as B
from optix_raytracer_tpu_torch.wavefront import intersect

from torch_parity import (bf_mesh, bf_rays, cull_edge_rays, group_box_table,
                          lone_gated_rays, rays8, tie_rays, torch_scene)
from torch_parity import one_torch_thread  # noqa: F401

M_GRID = (1, 9, 10, 31, 32, 33, 257, 482, 700)


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_culled_equal(geom, tri_mat, rays, boxes=None):
    """The culled loops (boxes: bf_group_boxes by default) against brute
    force, bit for bit; → (hits, occ)."""
    if boxes is None:
        boxes = G.bf_group_boxes(geom)
    tri = geom.tri_consts
    ref = P.closest_hit_plain(tri, tri_mat, rays)
    out = P.closest_hit_groups_plain(tri, tri_mat, rays, boxes)
    for k in ("t", "prim_id", "mat_id", "uv", "normal"):
        assert out[k].dtype == ref[k].dtype, k
        assert torch.equal(bits(out[k]), bits(ref[k])), k
    occ = P.any_hit_plain(tri, rays)
    assert torch.equal(P.any_hit_groups_plain(tri, rays, boxes), occ)
    return ref, occ


@pytest.mark.parametrize("m", M_GRID)
def test_culled_loops_equal_brute_force(m):
    """Random meshes across the cutoff and past 512 triangles, half the
    lanes dead: the culled loops give brute force's values."""
    geom, tri_mat = bf_mesh(m, seed=m)
    boxes = G.bf_group_boxes(geom)
    assert (boxes is None) == (m < G.FUSED_CULL_MIN_TRIS)
    if boxes is not None:
        assert boxes.shape == (-(-m // G.FUSED_GROUP), G.BOX_COLS)
    rays = bf_rays(1200, seed=100 + m, geom=geom)
    ref, occ = assert_culled_equal(geom, tri_mat, rays)
    assert (ref["prim_id"] >= 0).any() and occ.any()
    dead = rays.tmax <= rays.tmin
    assert 0.4 < float(dead.float().mean()) < 0.6
    assert (ref["prim_id"][dead] == -1).all() and not occ[dead].any()


@pytest.mark.parametrize("group", [1, 4, 8, 16])
def test_ties_keep_the_lowest_id(group):
    """Duplicated triangles (a pair in different groups) and rays through
    shared edges: the lowest id wins every tie, as brute force's argmin, in
    the culled loop kernels 1-3 share (_group_walk) at each group size the
    fused kernel takes, and at kernels 1-2's interface (FUSED_GROUP)."""
    geom, tri_mat = bf_mesh(64, seed=5, dup=True)
    tri = geom.tri_consts
    rays = tie_rays(geom)      # at the triangles' centroids and vertices
    boxes = G.fused_group_boxes(geom, group)
    args = (rays.origin, rays.direction, rays.tmin, rays.tmax)
    ref = P.closest_hit_plain(tri, tri_mat, rays)
    bt, bid, _, _, _ = P._group_walk(tri, boxes, group, *args, False)
    assert torch.equal(bits(bt), bits(ref["t"]))
    assert torch.equal(bid.to(torch.int32), ref["prim_id"])
    assert torch.equal(P._group_walk(tri, boxes, group, *args, True)[1],
                       P.any_hit_plain(tri, rays))
    if group == G.FUSED_GROUP:
        assert_culled_equal(geom, tri_mat, rays, boxes)
    pid = ref["prim_id"]
    assert (pid >= 0).sum() > 48 and (pid[pid >= 0] < 32).all()
    # the duplicate of each hit triangle reaches the same t
    hit = pid >= 0
    o, d = rays.origin[hit], rays.direction[hit]
    tt, _, _, _ = P._tri_test(tri[pid[hit].long() + 32],
                              *[o[:, k:k + 1] for k in range(3)],
                              *[d[:, k:k + 1] for k in range(3)])
    same = torch.diagonal(tt) == ref["t"][hit]
    assert bool(same.all())


@pytest.mark.parametrize("m", [32, 482])
@pytest.mark.parametrize("widened", [True, False])
def test_culled_loops_on_edge_rays(m, widened, monkeypatch):
    """torch_parity.cull_edge_rays on the group boxes (+-0 and +-1e-12
    direction components, rays along faces, through corners and from
    faces, infinite windows, dead lanes and blocks), on the boxes the
    kernels test and on the unwidened ones."""
    geom, tri_mat = bf_mesh(m, seed=m + 1)
    boxes = G.bf_group_boxes(geom)
    aim = boxes
    if not widened:
        monkeypatch.setattr(G.cluster_mod, "SC_MARGIN_REL", 0.0)
        monkeypatch.setattr(G.cluster_mod, "SC_MARGIN_FLOOR", 0.0)
        aim = G.bf_group_boxes(geom)
        monkeypatch.undo()
    r8 = cull_edge_rays(group_box_table(aim), seed=m, n=2048)
    ref, occ = assert_culled_equal(geom, tri_mat, rays8(r8), boxes)
    assert (ref["prim_id"] >= 0).any() and occ.any()


def test_culled_loops_on_lone_gated_rays():
    """The walks' lone grazing rays on knot_scene(20, 14)'s 562 triangles
    (blocks of one grazing ray and one ray through the cluster it grazes,
    the rest dead)."""
    scene = B.knot_scene(20, 14, device="cpu")
    r8 = lone_gated_rays(scene.geom, scene.clusters, seeds=range(2))
    ref, occ = assert_culled_equal(scene.geom, scene.tri_mat, rays8(r8))
    assert (ref["prim_id"] >= 0).sum() > 2 and occ.any()


def test_culled_loops_on_instance_slices():
    """The instanced Cornell box: each instance's slice of the shared
    table with its own boxes (DeviceScene.bf_boxes, built once), rays
    moved into the instance's object space; and the instance loop's query
    through the scene, which hands the loop those boxes."""
    scene = B.cornell_box_instanced("cpu")
    boxes = scene.bf_boxes
    assert scene.bf_boxes is boxes and len(boxes) == 3
    assert boxes[1] is boxes[2]          # one shared range, one table
    rng = np.random.default_rng(3)
    o = rng.uniform([50, 50, -300], [500, 500, -100], (800, 3))
    d = rng.uniform([0, 0, 0], [556, 548, 559], (800, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r8 = np.concatenate([o, d, np.full((800, 1), 1e-2),
                         rng.choice([1e16, 0.0], (800, 1))], axis=1)
    rays = rays8(r8)
    ranges = tlas.instance_ranges(scene.instances, scene.num_triangles)
    for i, (lo, hi) in enumerate(ranges):
        sub = tlas.slice_geometry(scene.geom, lo, hi)
        assert torch.equal(boxes[i], G.fused_group_boxes(sub, G.FUSED_GROUP))
        obj = tlas._object_rays(scene.instances.inv_transform[i], rays,
                                rays.tmax)
        assert_culled_equal(sub, scene.tri_mat[lo:hi], obj, boxes[i])


def test_scene_queries_pass_cached_boxes(monkeypatch):
    """A flat scene's brute-force queries get DeviceScene.bf_boxes[0], the
    same tensor on every call; an instanced scene's loop gets each
    instance's; below the cutoff there are none."""
    seen = []

    def spy(name):
        fn = getattr(P, name)

        def call(*args, boxes=None, **kw):
            seen.append(boxes)
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(P, "closest_hit", spy("closest_hit"))
    monkeypatch.setattr(P, "any_hit", spy("any_hit"))
    scene = B.cornell_box("cpu")
    rays = bf_rays(64, seed=1, dead=0.0)
    for _ in range(2):
        intersect.scene_closest(scene, rays)
        intersect.scene_any(scene, rays)
    assert all(b is scene.bf_boxes[0] for b in seen) and len(seen) == 4
    assert scene.bf_boxes[0].shape == (4, G.BOX_COLS)
    seen.clear()
    inst = B.cornell_box_instanced("cpu")
    intersect.scene_closest(inst, rays)
    intersect.scene_any(inst, rays)
    assert [b is x for b, x in zip(seen, inst.bf_boxes * 2)] == [True] * 6
    small, _ = bf_mesh(9, seed=2)
    assert G.bf_group_boxes(small) is None


def test_culled_closest_matches_jax_on_cornell():
    """16x16 Cornell camera rays: the culled closest hit against the JAX
    package's Pallas kernel in interpret mode: ids equal, t within rtol
    1e-5, uv 1e-4, normals 1e-5 (XLA contracts FMAs on the CPU)."""
    js = jcornell()
    ts = torch_scene(js)
    w = h = 16
    cam = B.cornell_camera(w, h).params("cpu")
    state = trng.seed(torch.arange(w * h, dtype=torch.int64), 0).reshape(h, w)
    rays, _ = generate_rays(cam, w, h, rng_state=state)
    rays = rays.reshape(w * h)
    out = P.closest_hit_groups_plain(ts.geom.tri_consts, ts.tri_mat, rays,
                                     ts.bf_boxes[0])
    jr = JRays.make(jnp.asarray(rays.origin.numpy()),
                    jnp.asarray(rays.direction.numpy()),
                    tmin=jnp.asarray(rays.tmin.numpy()),
                    tmax=jnp.asarray(rays.tmax.numpy()))
    ref = jpbf.closest_hit(js.geom.tri_consts, js.tri_mat, jr, interpret=True)
    for k in ("prim_id", "mat_id"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    assert (np.asarray(ref["prim_id"]) >= 0).sum() > 200
    np.testing.assert_allclose(out["t"].numpy(), np.asarray(ref["t"]),
                               rtol=1e-5)
    np.testing.assert_allclose(out["uv"].numpy(), np.asarray(ref["uv"]),
                               atol=1e-4)
    np.testing.assert_allclose(out["normal"].numpy(),
                               np.asarray(ref["normal"]), atol=1e-5)
