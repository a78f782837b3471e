"""Cosine-hemisphere sampling (counterpart of `shade/sampling.py:18-48`)."""
from __future__ import annotations

import math

import torch

from ..core.vecmath import normalize, orthonormal_basis


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
