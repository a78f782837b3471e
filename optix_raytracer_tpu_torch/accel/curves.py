"""Curve strands (the port's own copy of the numpy-only `accel/curves.py`):
spline evaluation for the five bases (linear, quadratic and cubic
B-spline, Catmull-Rom, Bézier), a strand's tessellation into capsule
(kind 3) or ribbon (parallelogram, kind 2) prim dicts, its spans as swept
prim dicts (kinds 4-5, power-basis coefficients), and the `.hair` reader.
Everything here is numpy on the host; `primitives.make_prims` puts the
dicts on a device.
"""
from __future__ import annotations

import numpy as np

LINEAR = "linear"
QUADRATIC_BSPLINE = "quadratic_bspline"
CUBIC_BSPLINE = "cubic_bspline"
CATMULL_ROM = "catmullrom"
BEZIER = "bezier"

# Basis matrices (rows: t^0..t^3 coefficients per control point).
_BASIS = {
    CUBIC_BSPLINE: np.array([[1, 4, 1, 0],
                             [-3, 0, 3, 0],
                             [3, -6, 3, 0],
                             [-1, 3, -3, 1]], np.float32) / 6.0,
    CATMULL_ROM: np.array([[0, 2, 0, 0],
                           [-1, 0, 1, 0],
                           [2, -5, 4, -1],
                           [-1, 3, -3, 1]], np.float32) / 2.0,
    BEZIER: np.array([[1, 0, 0, 0],
                      [-3, 3, 0, 0],
                      [3, -6, 3, 0],
                      [-1, 3, -3, 1]], np.float32),
}

_QUAD_BSPLINE = np.array([[1, 1, 0],
                          [-2, 2, 0],
                          [1, -2, 1]], np.float32) / 2.0


def eval_spline(control, widths, kind: str, samples_per_segment: int = 8):
    """Evaluate one strand → (points [S, 3], radii [S], u [S]).

    control: [C, 3] control points, widths: [C] per-control radii.
    """
    control = np.asarray(control, np.float32)
    widths = np.asarray(widths, np.float32)
    c = len(control)
    ts = np.linspace(0.0, 1.0, samples_per_segment, endpoint=False,
                     dtype=np.float32)

    if kind == LINEAR:
        segs = [(control[i:i + 2], widths[i:i + 2]) for i in range(c - 1)]
        basis = np.stack([1 - ts, ts], axis=1)                # [T, 2]
        powers = None
    elif kind == QUADRATIC_BSPLINE:
        segs = [(control[i:i + 3], widths[i:i + 3]) for i in range(c - 2)]
        powers = np.stack([np.ones_like(ts), ts, ts * ts], 1)  # [T, 3]
        basis = powers @ _QUAD_BSPLINE
    else:
        m = _BASIS[kind]
        step = 3 if kind == BEZIER else 1
        segs = [(control[i:i + 4], widths[i:i + 4])
                for i in range(0, c - 3, step)]
        powers = np.stack([np.ones_like(ts), ts, ts * ts, ts ** 3], 1)
        basis = powers @ m

    pts, rads, us = [], [], []
    n_segs = len(segs)
    for si, (cp, wd) in enumerate(segs):
        pts.append(basis @ cp)                 # [T, 3]
        rads.append(basis @ wd)
        us.append((si + ts) / n_segs)
    # closing sample at u = 1
    if kind == LINEAR:
        pts.append(control[-1:])
        rads.append(widths[-1:])
    else:
        end_basis = (np.array([[1.0, 1, 1]], np.float32) @ _QUAD_BSPLINE
                     if kind == QUADRATIC_BSPLINE else
                     np.array([[1.0, 1, 1, 1]], np.float32) @ _BASIS[kind])
        pts.append(end_basis @ segs[-1][0])
        rads.append(end_basis @ segs[-1][1])
    us.append(np.array([1.0], np.float32))
    return (np.concatenate(pts), np.concatenate(rads), np.concatenate(us))


def strand_to_capsules(points, radii, mat_id: int = 0):
    """Polyline → capsule prim descriptors (round curve)."""
    from . import primitives as prim
    descs = []
    for i in range(len(points) - 1):
        descs.append({"kind": prim.CAPSULE, "p0": points[i],
                      "p1": points[i + 1],
                      "radius": float(0.5 * (radii[i] + radii[i + 1])),
                      "mat_id": mat_id})
    return descs


def strand_to_ribbons(points, radii, normal=(0, 1, 0), mat_id: int = 0):
    """Polyline → flat oriented parallelogram strip (the ribbon primitive,
    `optixRibbons`): each segment becomes a quad spanning ±radius across the
    segment direction, oriented by `normal`."""
    from . import primitives as prim
    normal = np.asarray(normal, np.float32)
    descs = []
    for i in range(len(points) - 1):
        p0, p1 = points[i], points[i + 1]
        d = p1 - p0
        side = np.cross(d, normal)
        ln = np.linalg.norm(side)
        if ln < 1e-12:
            continue
        side = side / ln * radii[i]
        descs.append({"kind": prim.PARALLELOGRAM,
                      "anchor": p0 - side, "v1": 2 * side, "v2": d,
                      "mat_id": mat_id})
    return descs


def load_hair_file(path: str):
    """Parse the cem-yuksel `.hair` binary format (the optixHair input,
    `SDK/optixHair` loads `.hair` files): returns (strand_points list,
    strand_radii list). Supports the segments/points/thickness arrays."""
    import struct
    with open(path, "rb") as f:
        data = f.read()
    magic = data[:4]
    assert magic == b"HAIR", "not a .hair file"
    (num_strands, num_points, flags, d_segments, d_thickness, _d_trans,
     _d_color) = struct.unpack_from("<IIIIIII", data, 4)
    default_thickness = struct.unpack_from("<f", data, 40)[0]
    offset = 128
    has_segments = flags & 1
    has_points = flags & 2
    has_thickness = flags & 4
    if has_segments:
        segments = np.frombuffer(data, np.uint16, num_strands, offset)
        offset += 2 * num_strands
    else:
        segments = np.full(num_strands, d_segments, np.uint16)
    assert has_points, ".hair file without points"
    points = np.frombuffer(data, np.float32, num_points * 3,
                           offset).reshape(-1, 3)
    offset += 12 * num_points
    if has_thickness:
        thickness = np.frombuffer(data, np.float32, num_points, offset)
    else:
        thickness = np.full(num_points, default_thickness, np.float32)
    strands, radii = [], []
    p = 0
    for s in segments:
        n = int(s) + 1
        strands.append(points[p:p + n])
        radii.append(thickness[p:p + n])
        p += n
    return strands, radii


def strand_to_swept_cubics(control, widths, kind: str = CUBIC_BSPLINE,
                           mat_id: int = 0):
    """Cubic strand → true swept-curve prim dicts (one per span).

    kind: CUBIC_BSPLINE, CATMULL_ROM or BEZIER — the power-basis transform
    is the only difference (the ROUND_CUBIC_* builtin intersector roles,
    `optix_device.h:610-699`). Replaces capsule tessellation with the exact
    swept-sphere surface of each degree-3 span.
    """
    from . import primitives as prim
    control = np.asarray(control, np.float32)
    widths = np.asarray(widths, np.float32)
    m = _BASIS[kind]
    step = 3 if kind == BEZIER else 1
    c = len(control)
    starts = list(range(0, c - 3, step))
    nspans = len(starts)
    out = []
    for si, k in enumerate(starts):
        a = m @ control[k:k + 4]                 # [4, 3] rows: s^0..s^3
        r = m @ widths[k:k + 4]
        out.append({"kind": prim.SWEPT_CUBIC, "mat_id": mat_id,
                    "a0": a[0], "a1": a[1], "a2": a[2], "a3": a[3],
                    "r": tuple(r),
                    "u_range": (si / nspans, (si + 1) / nspans)})
    return out


def strand_to_swept_quads(control, widths, mat_id: int = 0):
    """Quadratic-bspline strand → true swept-curve prim dicts.

    Each span becomes one SWEPT_QUAD primitive holding power-basis
    position/radius polynomials — OptiX's built-in
    ROUND_QUADRATIC_BSPLINE intersector role (`optix_device.h:610-699`),
    replacing capsule tessellation with the exact swept-sphere surface.
    """
    from . import primitives as prim
    control = np.asarray(control, np.float32)
    widths = np.asarray(widths, np.float32)
    c = len(control)
    nspans = max(c - 2, 0)
    out = []
    for k in range(nspans):
        a = _QUAD_BSPLINE @ control[k:k + 3]     # [3, 3] rows: s^0 s^1 s^2
        r = _QUAD_BSPLINE @ widths[k:k + 3]
        out.append({"kind": prim.SWEPT_QUAD, "mat_id": mat_id,
                    "a0": a[0], "a1": a[1], "a2": a[2], "r": tuple(r),
                    "u_range": (k / nspans, (k + 1) / nspans)})
    return out
