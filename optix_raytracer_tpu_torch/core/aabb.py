"""Axis-aligned boxes as (lo, hi) pairs of [..., 3] tensors (counterpart of
`core/aabb.py`)."""
from __future__ import annotations

import torch


def empty(batch_shape=(), device=None):
    shape = tuple(batch_shape) + (3,)
    return (torch.full(shape, float("inf"), dtype=torch.float32,
                       device=device),
            torch.full(shape, float("-inf"), dtype=torch.float32,
                       device=device))


def from_points(pts, axis=-2):
    """The box over a set of points, reducing `axis`."""
    return torch.amin(pts, dim=axis), torch.amax(pts, dim=axis)


def union(a, b):
    return torch.minimum(a[0], b[0]), torch.maximum(a[1], b[1])


def center(box):
    return 0.5 * (box[0] + box[1])


def extent(box):
    return box[1] - box[0]


def surface_area(box):
    d = torch.clamp_min(box[1] - box[0], 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                  + d[..., 2] * d[..., 0])


def intersect_ray(lo, hi, origin, inv_dir, tmin, tmax):
    """Slab test over leading axes → (hit [...], t_enter [...]). inv_dir is
    1 / direction; an infinite component on a zero direction is fine."""
    t0 = (lo - origin) * inv_dir
    t1 = (hi - origin) * inv_dir
    t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
    t_enter = torch.maximum(t_near, tmin)
    hit = (t_enter <= torch.minimum(t_far, tmax)) & (t_far >= tmin)
    return hit, t_enter
