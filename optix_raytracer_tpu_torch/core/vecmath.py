"""Vector math over [..., 3] tensors (counterpart of `core/vecmath.py`).

Dot products are summed in the fixed order ((x + y) + z), the order the
fused kernel uses, so the wavefront engine and the kernel round alike.
"""
from __future__ import annotations

import torch


def dot(a, b):
    """Batched dot product over the last axis → [...]."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def length(a):
    return torch.sqrt(torch.clamp_min(dot(a, a), 0.0))


def normalize(a, eps=1e-20):
    """a / |a| with |a|² clamped away from zero."""
    return a * torch.reciprocal(torch.sqrt(torch.clamp_min(dot(a, a), eps)))[..., None]


def reflect(i, n):
    """Mirror `i` (pointing toward the surface) about `n`."""
    return i - 2.0 * dot(i, n)[..., None] * n


def refract(i, n, eta):
    """Snell refraction (`core/vecmath.py:61-76`) → (direction, ok). `i`
    points toward the surface, `n` away from it, eta = n_i / n_t. On total
    internal reflection ok is False and the direction zero."""
    eta = torch.as_tensor(eta, dtype=torch.float32, device=i.device)
    cos_i = -dot(i, n)
    sin2_t = (eta * eta) * torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    ok = sin2_t <= 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    d = eta[..., None] * i + (eta * cos_i - cos_t)[..., None] * n
    return torch.where(ok[..., None], d, 0.0), ok


def orthonormal_basis(n):
    """Branchless Frisvad/Duff (tangent, bitangent) around unit normal n."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    bt = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return t, bt
