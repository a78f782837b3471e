"""The port's custom primitives, scene features and prim-aware intersection
against the JAX package on the CPU.

Inputs come from a numpy seed and reach both sides as the same f32 bits.
Both sides run the same operations in the same order, op by op (JAX
eagerly, outside jit), so ids and occlusion are compared for equality, hit
t within 2 ulps (rtol 2.5e-7: XLA's CPU sqrt and 3-term sums land an ulp
apart on a few rays), normals within 4 ulps of 1 (atol 5e-7), and uv within
2e-5,
as near a sphere's poles the two libraries' asin / atan2 round apart by
more than an ulp (uv reaches no shading in either package)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_raytracer_tpu.accel import primitives as jprim
from optix_raytracer_tpu.core.rays import Hits as JHits
from optix_raytracer_tpu.core.rays import Rays as JRays
from optix_raytracer_tpu.scene.device_scene import make_device_scene as jmake
from optix_raytracer_tpu.wavefront import intersect as jintersect
from optix_raytracer_tpu_torch.accel import primitives as prim
from optix_raytracer_tpu_torch.core.rays import Hits, Rays
from optix_raytracer_tpu_torch.scene import builtins as tb
from optix_raytracer_tpu_torch.scene.device_scene import (
    device_scene_from_numpy, make_device_scene)
from optix_raytracer_tpu_torch.shade import materials as M
from optix_raytracer_tpu_torch.wavefront import engine, intersect

from torch_parity import jax_prims_scene, scene_fields

T_RTOL = 2.5e-7
NORMAL_ATOL = 5e-7
UV_ATOL = 2e-5


def _table(kind, rng):
    """Three prims of `kind` (or one of each kind for kind None) with
    random placements, material ids 0-4."""
    out = []
    kinds = [kind] * 3 if kind is not None else [
        prim.SPHERE, prim.SPHERE_SHELL, prim.PARALLELOGRAM, prim.CAPSULE]
    for k in kinds:
        c = tuple(rng.uniform(-1.5, 1.5, 3))
        mid = int(rng.integers(0, 5))
        if k == prim.SPHERE:
            out.append({"kind": k, "center": c,
                        "radius": float(rng.uniform(0.3, 0.8)), "mat_id": mid})
        elif k == prim.SPHERE_SHELL:
            r_in = float(rng.uniform(0.2, 0.5))
            out.append({"kind": k, "center": c, "radius_inner": r_in,
                        "radius_outer": r_in + float(rng.uniform(0.1, 0.4)),
                        "mat_id": mid})
        elif k == prim.PARALLELOGRAM:
            out.append({"kind": k, "anchor": c,
                        "v1": tuple(rng.uniform(-1.2, 1.2, 3)),
                        "v2": tuple(rng.uniform(-1.2, 1.2, 3)), "mat_id": mid})
        else:
            out.append({"kind": k, "p0": c,
                        "p1": tuple(np.asarray(c) + rng.uniform(-1, 1, 3)),
                        "radius": float(rng.uniform(0.1, 0.4)), "mat_id": mid})
    return out


def _rays(table, rng, n=600):
    """Random rays through the prims' region: a third starting inside a
    prim (at a sphere's or shell's centre, or between a shell's radii), a
    third aimed near a prim's middle, windows of tmax 50 or 1.5."""
    o = rng.uniform(-3, 3, (n, 3))
    d = rng.normal(size=(n, 3))
    for i in range(1, n, 3):
        p = table[(i // 3) % len(table)]
        mid = np.asarray(p.get("center", p.get("anchor", p.get("p0"))))
        if p["kind"] == prim.PARALLELOGRAM:
            mid = mid + 0.5 * (np.asarray(p["v1"]) + np.asarray(p["v2"]))
        d[i] = mid + rng.uniform(-0.4, 0.4, 3) - o[i]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    for i in range(0, n, 3):
        p = table[(i // 3) % len(table)]
        if p["kind"] == prim.SPHERE:
            o[i] = p["center"]
        elif p["kind"] == prim.SPHERE_SHELL:
            mid = 0.5 * (p["radius_inner"] + p["radius_outer"])
            o[i] = np.asarray(p["center"]) + (d[i] * mid if i % 2 else 0.0)
        elif p["kind"] == prim.CAPSULE:
            o[i] = p["p0"]
    tmax = np.where(rng.random(n) < 0.8, 50.0, 1.5)
    return (o.astype(np.float32), d.astype(np.float32),
            np.full(n, 1e-3, np.float32), tmax.astype(np.float32))


def _both(table, rays):
    o, d, tmin, tmax = rays
    return ((jprim.make_prims(table),
             JRays(origin=jnp.asarray(o), direction=jnp.asarray(d),
                   tmin=jnp.asarray(tmin), tmax=jnp.asarray(tmax))),
            (prim.make_prims(table, "cpu"),
             Rays(origin=torch.as_tensor(o), direction=torch.as_tensor(d),
                  tmin=torch.as_tensor(tmin), tmax=torch.as_tensor(tmax))))


def test_make_prims_fields_equal_jax():
    rng = np.random.default_rng(1)
    table = _table(None, rng) + [
        {"kind": prim.SWEPT_QUAD, "a0": (0, 0, 0), "a1": (1, 0, 0),
         "a2": (0, 1, 0), "r": (0.1, 0.0, 0.0)},
        {"kind": prim.SWEPT_CUBIC, "a0": (0, 0, 0), "a1": (1, 0, 0),
         "a2": (0, 1, 0), "a3": (0, 0, 1), "r": (0.1, 0, 0, 0),
         "u_range": (0.2, 0.7)}]
    jp, tp = jprim.make_prims(table), prim.make_prims(table, "cpu")
    for f in ("kind", "params", "mat_id"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)))
    assert tp.kinds_static == jp.kinds_static == (0, 1, 2, 3, 4, 5)
    assert tp.params.dtype == torch.float32 and tp.kind.dtype == torch.int32
    with pytest.raises(ValueError):
        prim.make_prims([{"kind": 9}], "cpu")


@pytest.mark.parametrize("kind", [prim.SPHERE, prim.SPHERE_SHELL,
                                  prim.PARALLELOGRAM, prim.CAPSULE, None])
def test_closest_matches_jax(kind):
    rng = np.random.default_rng(10 + (kind if kind is not None else 9))
    table = _table(kind, rng)
    (jp, jr), (tp, tr) = _both(table, _rays(table, rng))
    ref = jprim.intersect_prims_closest(jp, jr)
    out = prim.intersect_prims_closest(tp, tr)
    hit = np.asarray(ref.prim_id) >= 0
    assert 0.1 < hit.mean() < 0.9
    for f in ("prim_id", "inst_id", "mat_id"):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    np.testing.assert_allclose(out.t.numpy(), np.asarray(ref.t), rtol=T_RTOL,
                               atol=0)
    np.testing.assert_allclose(out.normal.numpy(), np.asarray(ref.normal),
                               rtol=0, atol=NORMAL_ATOL)
    np.testing.assert_allclose(out.uv.numpy()[hit], np.asarray(ref.uv)[hit],
                               rtol=0, atol=UV_ATOL)


@pytest.mark.parametrize("kind", [prim.SPHERE, prim.SPHERE_SHELL,
                                  prim.PARALLELOGRAM, prim.CAPSULE, None])
def test_any_matches_jax(kind):
    rng = np.random.default_rng(20 + (kind if kind is not None else 9))
    table = _table(kind, rng)
    (jp, jr), (tp, tr) = _both(table, _rays(table, rng))
    ref = np.asarray(jprim.intersect_prims_any(jp, jr))
    assert 0.1 < ref.mean() < 0.95
    np.testing.assert_array_equal(prim.intersect_prims_any(tp, tr).numpy(),
                                  ref)


def test_merge_hits_matches_jax():
    """A triangle hit set (random t, ids, a quarter misses) merged with the
    prim hits: the nearer wins, the triangle on a tie, prim ids offset."""
    rng = np.random.default_rng(5)
    table = _table(None, rng)
    rays = _rays(table, rng)
    (jp, jr), (tp, tr) = _both(table, rays)
    n = rays[0].shape[0]
    miss = rng.random(n) < 0.25
    a = dict(t=np.where(miss, rays[3], rng.uniform(0.5, 4, n)).astype(
                 np.float32),
             prim_id=np.where(miss, -1, rng.integers(0, 30, n)).astype(
                 np.int32),
             inst_id=np.where(miss, -1, 0).astype(np.int32),
             mat_id=np.where(miss, -1, rng.integers(0, 5, n)).astype(
                 np.int32),
             uv=rng.random((n, 2)).astype(np.float32),
             normal=rng.normal(size=(n, 3)).astype(np.float32))
    jb = jprim.intersect_prims_closest(jp, jr)
    tb_ = prim.intersect_prims_closest(tp, tr)
    a["t"][:8] = np.asarray(jb.t)[:8]          # exact ties: a wins
    ref = jprim.merge_hits(JHits(**{k: jnp.asarray(v) for k, v in a.items()}),
                           jb, prim_offset=30)
    out = prim.merge_hits(Hits(**{k: torch.as_tensor(v)
                                  for k, v in a.items()}), tb_,
                          prim_offset=30)
    for f in ("prim_id", "inst_id", "mat_id"):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    np.testing.assert_allclose(out.t.numpy(), np.asarray(ref.t), rtol=T_RTOL,
                               atol=0)
    np.testing.assert_allclose(out.normal.numpy(), np.asarray(ref.normal),
                               rtol=0, atol=NORMAL_ATOL)
    np.testing.assert_allclose(out.uv.numpy(), np.asarray(ref.uv), rtol=0,
                               atol=UV_ATOL)
    won = out.prim_id.numpy() >= 30
    assert won.any() and (~won).any()


def test_swept_prims_raise():
    """A table holding a swept curve span is served now (kinds 4-5 are
    ported): its queries answer and the engine renders it, but the fused
    kernel never takes it (its kinds are 0-3), so impl "auto" takes the
    wavefront. A kind outside the six still raises."""
    table = tb.prims_list() + [
        {"kind": prim.SWEPT_QUAD, "a0": (0, 0, 0), "a1": (1, 0, 0),
         "a2": (0, 1, 0), "r": (0.1, 0.0, 0.0), "mat_id": 1}]
    tp = prim.make_prims(table, "cpu")
    rays = Rays.make(torch.zeros((4, 3)), torch.tensor([[0.0, 0, 1]] * 4))
    hits = prim.intersect_prims_closest(tp, rays)
    assert torch.equal(prim.intersect_prims_any(tp, rays), hits.prim_id >= 0)
    verts, idx = tb.prims_floor()
    scene = make_device_scene(verts, idx, np.zeros(2, np.int32),
                              tb.PRIMS_MATERIALS, "cpu", prims=tp)
    assert not engine._use_fused(dataclasses.replace(scene), "auto")
    img, _ = engine.render_sample(scene, tb.prims_camera(4, 4).params("cpu"),
                                  4, 4, 0, max_depth=1)
    assert img.shape == (4, 4, 3) and bool(torch.isfinite(img).all())
    bad = dataclasses.replace(tp, kinds_static=tp.kinds_static[:-1] + (6,))
    with pytest.raises(ValueError, match="unknown custom prim kinds"):
        prim.intersect_prims_closest(bad, rays)
    with pytest.raises(ValueError, match="unknown custom prim kinds"):
        dataclasses.replace(scene, prims=bad).require_supported()


_MATERIAL_CASES = {
    "diffuse": [{"kind": M.DIFFUSE}, {"kind": M.EMISSIVE,
                                      "emission": (1, 1, 1)}],
    "glass": [{"kind": M.DIFFUSE}, {"kind": M.GLASS, "ior": 1.33}],
    "mirror": [{"kind": M.DIFFUSE},
               {"kind": M.PBR, "metallic": 1.0, "roughness": 0.05}],
    "rough_pbr": [{"kind": M.PBR, "metallic": 1.0, "roughness": 0.06},
                  {"kind": M.PBR}],
    "mixed": [{"kind": M.GLASS}, {"kind": M.PBR, "metallic": 0.3},
              {"kind": M.PBR, "metallic": 0.995, "roughness": 0.0},
              {"kind": M.DIFFUSE, "kr": (0.5, 0.5, 0.5)}],
}


@pytest.mark.parametrize("case", sorted(_MATERIAL_CASES))
def test_features_match_jax(case):
    """make_device_scene's feature tags equal the reference's for diffuse,
    glass, mirror, rough PBR and mixed material lists, and so do the
    material tables."""
    mats = _MATERIAL_CASES[case]
    verts, idx = tb.prims_floor()
    tri_mat = np.array([0, len(mats) - 1], np.int32)
    js = jmake(verts, idx, tri_mat, mats)
    ts = make_device_scene(verts, idx, tri_mat, mats, "cpu")
    assert ts.features == tuple(js.features)
    assert ts.has_pbr == js.has_pbr
    ref = scene_fields(js)
    m = ts.materials
    for key, val in (("mat_kind", m.kind), ("mat_base_color", m.base_color),
                     ("mat_metallic", m.metallic), ("mat_ior", m.ior),
                     ("mat_roughness", m.roughness), ("mat_kr", m.kr)):
        np.testing.assert_array_equal(val.numpy(), ref[key])


def test_prim_fields_round_trip():
    """The prim table reaches device_scene_from_numpy bit for bit, and the
    port's own prims scene equals the handed-over one."""
    js = jax_prims_scene()
    ts = device_scene_from_numpy(scene_fields(js), "cpu")
    np.testing.assert_array_equal(ts.prims.params.numpy(),
                                  np.asarray(js.prims.params))
    np.testing.assert_array_equal(ts.prims.kind.numpy(),
                                  np.asarray(js.prims.kind))
    np.testing.assert_array_equal(ts.prims.mat_id.numpy(),
                                  np.asarray(js.prims.mat_id))
    assert ts.prims.kinds_static == js.prims.kinds_static
    assert ts.features == js.features == ("glass",)
    own = tb.prims_scene("cpu")
    np.testing.assert_array_equal(own.prims.params.numpy(),
                                  ts.prims.params.numpy())
    assert own.features == ts.features
    empty = device_scene_from_numpy(scene_fields(jmake(
        *tb.prims_floor(), np.zeros(2, np.int32), tb.PRIMS_MATERIALS)), "cpu")
    assert empty.prims.num == 0 and empty.prims.params.shape == (0, 18)
    with pytest.raises(ValueError):
        make_device_scene(*tb.prims_floor(), np.zeros(2, np.int32),
                          tb.PRIMS_MATERIALS[:2], "cpu",
                          prims=prim.make_prims(tb.prims_list(), "cpu"))


def test_scene_queries_match_jax():
    """scene_closest / scene_any on the prims scene (2 floor triangles + 4
    prims): prim hits report num_triangles + row, as the reference."""
    js = jax_prims_scene()
    ts = device_scene_from_numpy(scene_fields(js), "cpu")
    rng = np.random.default_rng(3)
    n = 800
    o = np.concatenate([rng.uniform(-3, 3, (n, 1)), rng.uniform(0.05, 3,
                                                               (n, 1)),
                        rng.uniform(-3, 3, (n, 1))], axis=1).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.random(n) < 0.7, 1e16, 2.0).astype(np.float32)
    jr = JRays(origin=jnp.asarray(o), direction=jnp.asarray(d),
               tmin=jnp.full((n,), 1e-2, jnp.float32), tmax=jnp.asarray(tmax))
    tr = Rays(origin=torch.as_tensor(o), direction=torch.as_tensor(d),
              tmin=torch.full((n,), 1e-2), tmax=torch.as_tensor(tmax))
    ref = jintersect.scene_closest(js, jr, chunk_size=None)
    out = intersect.scene_closest(ts, tr)
    ids = out.prim_id.numpy()
    np.testing.assert_array_equal(ids, np.asarray(ref.prim_id))
    np.testing.assert_array_equal(out.mat_id.numpy(), np.asarray(ref.mat_id))
    assert (ids >= 2).any() and ((ids >= 0) & (ids < 2)).any()
    hit = ids >= 0
    np.testing.assert_allclose(out.t.numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=1e-6)
    np.testing.assert_allclose(out.normal.numpy()[hit],
                               np.asarray(ref.normal)[hit], rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(
        intersect.scene_any(ts, tr).numpy(),
        np.asarray(jintersect.scene_any(js, jr, chunk_size=None)))
