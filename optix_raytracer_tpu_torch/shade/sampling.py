"""Cosine-hemisphere, GGX and uniform-sphere sampling (counterpart of
`shade/sampling.py:18-73`)."""
from __future__ import annotations

import math

import torch

from ..core.vecmath import normalize, orthonormal_basis

TWO_PI = 6.283185307179586


def concentric_sample_disk(u1, u2):
    """Shirley-Chiu concentric disk mapping, branchless."""
    ox = 2.0 * u1 - 1.0
    oy = 2.0 * u2 - 1.0
    x_major = torch.abs(ox) > torch.abs(oy)
    # r keeps the sign of the major component: that spreads the samples
    # over all four quadrants.
    r = torch.where(x_major, ox, oy)
    safe_ox = torch.where(ox == 0.0, 1.0, ox)
    safe_oy = torch.where(oy == 0.0, 1.0, oy)
    theta = torch.where(x_major,
                        (math.pi / 4.0) * (oy / safe_ox),
                        (math.pi / 2.0) - (math.pi / 4.0) * (ox / safe_oy))
    r = torch.where((ox == 0.0) & (oy == 0.0), 0.0, r)
    return r * torch.cos(theta), r * torch.sin(theta)


def cosine_sample_hemisphere(u1, u2, normal):
    """Cosine-weighted direction about `normal`; pdf = cos(theta) / pi."""
    dx, dy = concentric_sample_disk(u1, u2)
    dz = torch.sqrt(torch.clamp_min(1.0 - dx * dx - dy * dy, 0.0))
    t, b = orthonormal_basis(normal)
    return normalize(dx[..., None] * t + dy[..., None] * b + dz[..., None] * normal)


def ggx_sample_half_vector(u1, u2, normal, roughness):
    """A GGX / Trowbridge-Reitz half-vector about `normal` (`shade/
    sampling.py:58-73`); pdf_h = D(h) cos(theta_h)."""
    a2 = roughness * roughness
    cos2 = (1.0 - u1) / torch.clamp_min(u1 * (a2 * a2 - 1.0) + 1.0, 1e-12)
    cos_t = torch.sqrt(torch.clamp(cos2, 0.0, 1.0))
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos2, 0.0))
    phi = TWO_PI * u2
    t, b = orthonormal_basis(normal)
    return normalize((sin_t * torch.cos(phi))[..., None] * t
                     + (sin_t * torch.sin(phi))[..., None] * b
                     + cos_t[..., None] * normal)


def uniform_sample_sphere(u1, u2):
    """Uniform direction on the unit sphere (`shade/sampling.py:50-55`)."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
