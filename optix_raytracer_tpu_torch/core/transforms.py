"""Affine 3-D transforms as [..., 3, 4] tensors, rotation | translation
(counterpart of `core/transforms.py:15-89`).

Every helper broadcasts over leading batch axes. The maps that trace rays
(`apply_point`, `apply_vector`, `normal_to_world`) are written out as
products and sums in a fixed order, ((m0 * x + m1 * y) + m2 * z) (+ m3), and
not as `einsum` or `@`: a matrix product reduces in an order of its own,
while the fused kernel (`csrc/pt_fused.cuh`) repeats this one, so the
wavefront and the kernel transform a ray to the same bits.
"""
from __future__ import annotations

import numpy as np
import torch


def _f32(x, device=None):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def identity(batch_shape=(), device=None):
    m = torch.zeros(tuple(batch_shape) + (3, 4), dtype=torch.float32,
                    device=device)
    m[..., :, :3] = torch.eye(3, dtype=torch.float32, device=device)
    return m


def from_rotation_translation(rot, trans):
    """rot: [..., 3, 3], trans: [..., 3] → [..., 3, 4]."""
    return torch.cat([rot, trans[..., :, None]], dim=-1)


def translate(t, device=None):
    t = _f32(t, device)
    eye = torch.eye(3, dtype=torch.float32, device=t.device)
    return from_rotation_translation(eye.expand(t.shape[:-1] + (3, 3)), t)


def scale(s, device=None):
    s = _f32(s, device)
    if s.ndim == 0:
        s = torch.stack([s, s, s])
    return from_rotation_translation(torch.diag_embed(s),
                                     torch.zeros_like(s))


def rotate(axis, angle, device=None):
    """Rodrigues rotation about `axis` by `angle` radians → [3, 4], with the
    reference's numpy arithmetic (the same bits)."""
    axis = np.asarray(axis, np.float32)
    axis = axis / np.linalg.norm(axis)
    x, y, z = axis
    c, s = np.cos(angle), np.sin(angle)
    C = 1.0 - c
    rot = _f32(np.asarray([
        [x * x * C + c, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, y * y * C + c, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, z * z * C + c],
    ]).astype(np.float32), device)
    return from_rotation_translation(rot, torch.zeros(3, dtype=torch.float32,
                                                      device=rot.device))


def _rows(m, v):
    """Row i of m[..., :, :3] dotted with v, for i = 0, 1, 2 → [..., 3]."""
    return torch.stack([(m[..., i, 0] * v[..., 0] + m[..., i, 1] * v[..., 1])
                        + m[..., i, 2] * v[..., 2] for i in range(3)], dim=-1)


def compose(a, b):
    """Transform composition: apply b first, then a. Both [..., 3, 4]."""
    rot = torch.stack([_rows(a, b[..., :, k]) for k in range(3)], dim=-1)
    trans = _rows(a, b[..., :, 3]) + a[..., :, 3]
    return from_rotation_translation(rot, trans)


def apply_point(m, p):
    """m: [..., 3, 4], p: [..., 3] → rotated + translated point."""
    return _rows(m, p) + m[..., :, 3]


def apply_vector(m, v):
    """Rotation / scale only (directions, no translation)."""
    return _rows(m, v)


def normal_to_world(inv, n):
    """An object-space normal back to world space by the inverse-transpose
    row rule w_k = sum_j n_j inv[j][k] (accel/tlas.py:151,
    wavefront/engine.py:343), over inv's linear part; not normalised."""
    return torch.stack([(n[..., 0] * inv[..., 0, k]
                         + n[..., 1] * inv[..., 1, k])
                        + n[..., 2] * inv[..., 2, k] for k in range(3)],
                       dim=-1)


def apply_normal(m, n):
    """Transform a normal by the inverse-transpose of the linear part."""
    return normal_to_world(torch.linalg.inv(m[..., :3]), n)


def inverse(m):
    """Inverse of an affine [..., 3, 4] transform."""
    rinv = torch.linalg.inv(m[..., :3])
    return from_rotation_translation(rinv, -_rows(rinv, m[..., :, 3]))


def to_4x4(m):
    pad = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float32,
                       device=m.device).expand(m.shape[:-2] + (1, 4))
    return torch.cat([m, pad], dim=-2)
