"""The port's curves (accel/curves.py, the swept prim kinds 4-5 of
accel/primitives.py, the ribbons app) against the JAX package on
the CPU, on the same numpy inputs made from a seed.

Bars: the spline evaluation, the four tessellations and the `.hair` reader
equal; swept-prim hits: masks and ids equal, t within rtol 1e-4, normals
and uv within 1e-3 (the acceptance bars); images within atol 3e-3 / rtol
1e-3 (tests/test_fused_kernel.py:238's bar for shaded prims), the pixels
outside the bar counted and required to be none.

The curves app is held in tests/test_torch_curves_apps.py, the hair app
in tests/test_torch_hair.py. About 45 s on one worker, a third of it the
JAX compile of the ribbons' Whitted sample.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_raytracer_tpu.accel import curves as jcv
from optix_raytracer_tpu.accel import primitives as jprim
from optix_raytracer_tpu.apps import ribbons as jribbons
from optix_raytracer_tpu.core.rays import Rays as JRays
from optix_raytracer_tpu_torch.accel import curves as cv
from optix_raytracer_tpu_torch.accel import primitives as prim
from optix_raytracer_tpu_torch.apps import ribbons
from optix_raytracer_tpu_torch.core.rays import Rays

from torch_parity import (assert_image_close, hair_bytes,  # noqa: F401
                          one_torch_thread)

T_RTOL = 1e-4
N_ATOL = 1e-3
UV_ATOL = 1e-3
ATOL = 3e-3
BASES = [cv.LINEAR, cv.QUADRATIC_BSPLINE, cv.CUBIC_BSPLINE, cv.CATMULL_ROM,
         cv.BEZIER]


def _strand(seed, n=7):
    """A curled random strand: n control points and tapering widths."""
    rng = np.random.default_rng(seed)
    steps = rng.normal(size=(n, 3)) * 0.3 + np.array([0.0, 0.35, 0.0])
    control = np.cumsum(steps, axis=0).astype(np.float32)
    control -= control.mean(axis=0)
    widths = np.linspace(0.12, 0.04, n).astype(np.float32)
    return control, widths


@pytest.mark.parametrize("basis", BASES)
def test_eval_spline_matches_jax(basis):
    control, widths = _strand(1)
    for sps in (1, 4, 9):
        out = cv.eval_spline(control, widths, basis, sps)
        ref = jcv.eval_spline(control, widths, basis, sps)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("basis", BASES)
def test_tessellations_match_jax(basis):
    """strand_to_capsules and strand_to_ribbons of the evaluated spline,
    strand_to_swept_quads, and strand_to_swept_cubics of each cubic basis:
    the same dicts, and make_prims gives the same table."""
    control, widths = _strand(2)
    pts, rad, _ = cv.eval_spline(control, widths, basis, 5)
    pairs = [(cv.strand_to_capsules(pts, rad, mat_id=2),
              jcv.strand_to_capsules(pts, rad, mat_id=2)),
             (cv.strand_to_ribbons(pts, rad, normal=(0.2, 0.1, 1.0),
                                   mat_id=1),
              jcv.strand_to_ribbons(pts, rad, normal=(0.2, 0.1, 1.0),
                                    mat_id=1)),
             (cv.strand_to_swept_quads(control, widths, mat_id=3),
              jcv.strand_to_swept_quads(control, widths, mat_id=3))]
    if basis in (cv.CUBIC_BSPLINE, cv.CATMULL_ROM, cv.BEZIER):
        pairs.append((cv.strand_to_swept_cubics(control, widths, kind=basis),
                      jcv.strand_to_swept_cubics(control, widths,
                                                 kind=basis)))
    for out, ref in pairs:
        assert len(out) == len(ref) > 0
        for a, b in zip(out, ref):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]), err_msg=k)
        tp, jp = prim.make_prims(out, "cpu"), jprim.make_prims(ref)
        np.testing.assert_array_equal(tp.params.numpy(), np.asarray(jp.params))
        assert tp.kinds_static == jp.kinds_static


def _swept_rays(descs, seed, n_each=60):
    """Rays at a table of swept spans: at the body (a point half a radius
    off the curve, from 1.5-3 away), at the strand's two end caps (from
    beyond each end along the tangent, slightly off axis), near misses (1.2
    radii off the curve, passing it sideways) and random rays through the
    region; tmin 1e-3, tmax 50 (every fifth ray 1.5)."""
    rng = np.random.default_rng(seed)
    table = prim.make_prims(descs, "cpu").params.numpy()
    kinds = [d["kind"] for d in descs]

    def curve(i, s):
        p = table[i]
        if kinds[i] == prim.SWEPT_CUBIC:
            a = [p[0:3], p[3:6], p[6:9], p[9:12]]
            r = p[12:16]
        else:
            a = [p[0:3], p[3:6], p[6:9], np.zeros(3, np.float32)]
            r = np.append(p[9:12], 0.0)
        pos = a[0] + s * (a[1] + s * (a[2] + s * a[3]))
        tan = a[1] + s * (2 * a[2] + s * 3 * a[3])
        rad = r[0] + s * (r[1] + s * (r[2] + s * r[3]))
        return pos, tan / np.linalg.norm(tan), rad

    def perp(t):
        v = np.cross(t, rng.normal(size=3))
        return v / np.linalg.norm(v)

    o, d = [], []
    for _ in range(n_each):                       # the body
        i, s = rng.integers(0, len(descs)), rng.uniform(0.05, 0.95)
        pos, tan, rad = curve(i, s)
        target = pos + 0.5 * rad * perp(tan)
        start = target + rng.uniform(1.5, 3.0) * perp(tan)
        o.append(start)
        d.append(target - start)
    for end, s in ((0, 0.0), (len(descs) - 1, 1.0)):   # the end caps
        for _ in range(n_each // 2):
            pos, tan, rad = curve(end, s)
            out = -tan if s == 0.0 else tan
            target = pos + 0.3 * rad * perp(tan)
            start = target + 2.0 * out + 0.2 * rad * perp(tan)
            o.append(start)
            d.append(target - start)
    for _ in range(n_each):                       # near misses
        i, s = rng.integers(0, len(descs)), rng.uniform(0.05, 0.95)
        pos, tan, rad = curve(i, s)
        side = perp(tan)
        target = pos + 1.2 * rad * side
        start = target + 2.5 * np.cross(tan, side)
        o.append(start)
        d.append(target - start)
    for _ in range(n_each):                       # random
        o.append(rng.uniform(-2, 2, 3))
        d.append(rng.normal(size=3))
    o = np.asarray(o, np.float32)
    d = np.asarray(d, np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    n = len(o)
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.where(np.arange(n) % 5 == 4, 1.5, 50.0).astype(np.float32)
    return (JRays(origin=jnp.asarray(o), direction=jnp.asarray(d),
                  tmin=jnp.asarray(tmin), tmax=jnp.asarray(tmax)),
            Rays(origin=torch.as_tensor(o), direction=torch.as_tensor(d),
                 tmin=torch.as_tensor(tmin), tmax=torch.as_tensor(tmax)))


def _assert_prim_hits(descs, jr, tr, what):
    tp, jp = prim.make_prims(descs, "cpu"), jprim.make_prims(descs)
    out = prim.intersect_prims_closest(tp, tr)
    ref = jprim.intersect_prims_closest(jp, jr)
    for f in ("prim_id", "mat_id", "inst_id"):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f"{what}: {f}")
    hit = out.prim_id.numpy() >= 0
    assert hit.sum() > 20 and (~hit).sum() > 20, f"{what}: degenerate rays"
    np.testing.assert_allclose(out.t.numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=T_RTOL, err_msg=f"{what}: t")
    np.testing.assert_allclose(out.normal.numpy(), np.asarray(ref.normal),
                               rtol=0, atol=N_ATOL, err_msg=f"{what}: normal")
    np.testing.assert_allclose(out.uv.numpy()[hit], np.asarray(ref.uv)[hit],
                               rtol=0, atol=UV_ATOL, err_msg=f"{what}: uv")
    occ = prim.intersect_prims_any(tp, tr)
    np.testing.assert_array_equal(
        occ.numpy(), np.asarray(jprim.intersect_prims_any(jp, jr)))
    return out


@pytest.mark.parametrize("kind", ["quad", cv.CUBIC_BSPLINE, cv.CATMULL_ROM,
                                  cv.BEZIER])
def test_swept_prims_match_jax(kind):
    control, widths = _strand(3 + len(kind))
    descs = (cv.strand_to_swept_quads(control, widths, mat_id=1)
             if kind == "quad" else
             cv.strand_to_swept_cubics(control, widths, kind=kind, mat_id=1))
    jr, tr = _swept_rays(descs, seed=len(kind))
    out = _assert_prim_hits(descs, jr, tr, f"swept {kind}")
    # the strand u of a span lies in its u range
    u = out.uv.numpy()[:, 0][out.prim_id.numpy() >= 0]
    assert (u >= 0).all() and (u <= 1).all()


def test_mixed_prim_table_matches_jax():
    """A table of kinds 0-5 together: the swept branch runs beside the
    other kinds, and each prim reports its own normal and uv."""
    control, widths = _strand(9)
    descs = [{"kind": prim.SPHERE, "center": (1.2, 0.3, -0.4),
              "radius": 0.4, "mat_id": 0},
             {"kind": prim.SPHERE_SHELL, "center": (-1.2, -0.5, 0.3),
              "radius_inner": 0.3, "radius_outer": 0.5, "mat_id": 1},
             {"kind": prim.PARALLELOGRAM, "anchor": (-1.5, -1.2, -1.5),
              "v1": (3.0, 0.0, 0.0), "v2": (0.0, 0.2, 3.0), "mat_id": 2},
             {"kind": prim.CAPSULE, "p0": (0.3, -1.0, 1.0),
              "p1": (0.9, 0.2, 1.2), "radius": 0.15, "mat_id": 3}]
    descs += cv.strand_to_swept_quads(control[:4], widths[:4], mat_id=4)
    descs += cv.strand_to_swept_cubics(control[3:], widths[3:], mat_id=5)
    assert {d["kind"] for d in descs} == set(prim.PORTED_KINDS)
    jr, tr = _swept_rays(descs[4:], seed=11)
    out = _assert_prim_hits(descs, jr, tr, "mixed table")
    assert len(set(out.prim_id.numpy().tolist())) > 6


def test_kinds_0_3_skip_the_swept_branch(monkeypatch):
    """A table without kinds 4-5 never builds the swept solver; a swept
    table answers the same in ray chunks of any size."""
    def boom(*a, **k):
        raise AssertionError("swept solver on a table of kinds 0-3")

    control, widths = _strand(4)
    descs = cv.strand_to_swept_cubics(control, widths)
    jr, tr = _swept_rays(descs, seed=4, n_each=20)
    tp = prim.make_prims(descs, "cpu")
    whole = prim.intersect_prims_closest(tp, tr)
    monkeypatch.setattr(prim, "PLANE_ELEMS", 3 * tp.num)
    parts = prim.intersect_prims_closest(tp, tr)
    for f in ("t", "prim_id", "uv", "normal"):
        assert torch.equal(getattr(whole, f), getattr(parts, f)), f
    assert torch.equal(prim.intersect_prims_any(tp, tr),
                       (whole.prim_id >= 0))
    monkeypatch.setattr(prim, "_SweptSpans", boom)
    pts, rad, _ = cv.eval_spline(control, widths, cv.CUBIC_BSPLINE, 3)
    caps = prim.make_prims(cv.strand_to_capsules(pts, rad), "cpu")
    assert (prim.intersect_prims_closest(caps, tr).prim_id >= 0).any()


@pytest.mark.parametrize("with_arrays", [True, False])
def test_hair_file_read_equal(tmp_path, with_arrays):
    """A .hair file written here, with per-strand segments and per-point
    thickness or with the header's defaults, reads the same in both
    packages (and as written)."""
    rng = np.random.default_rng(12)
    points = rng.normal(size=(10, 3)).astype(np.float32)
    thick = np.linspace(0.1, 0.01, 10).astype(np.float32)
    if with_arrays:
        blob = hair_bytes(points, segments=[3, 5], thickness=thick)
        sizes = [4, 6]
    else:
        blob = hair_bytes(points)
        sizes = [5, 5]
    path = tmp_path / "t.hair"
    path.write_bytes(blob)
    strands, radii = cv.load_hair_file(str(path))
    jstrands, jradii = jcv.load_hair_file(str(path))
    assert [len(s) for s in strands] == [len(s) for s in jstrands] == sizes
    for a, b in zip(strands + radii, jstrands + jradii):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.concatenate(strands), points)
    np.testing.assert_array_equal(
        np.concatenate(radii), thick if with_arrays else np.full(10, 0.02,
                                                                 np.float32))


def test_ribbons_app_matches_jax():
    out, film, rays = ribbons.render(16, 16, samples=2, device="cpu")
    ref, jf = jribbons.render(16, 16, samples=2)
    assert int(film.subframe) == 2
    assert_image_close(out.numpy(), ref, "ribbons", atol=ATOL)
    assert int(rays) > 16 * 16 * 2
