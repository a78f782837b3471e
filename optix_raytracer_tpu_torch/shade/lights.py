"""Lights (counterpart of `shade/lights.py`): the parallelogram area light the
path tracer samples, and the table of point, ambient, directional and
volumetric lights the Whitted integrator loops over, with `sample_light`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import rng as _rng
from ..core.vecmath import cross, length, normalize

# Light kinds, the same tags as the JAX package (shade/lights.py:21-25).
POINT = 0
AMBIENT = 1
DIRECTIONAL = 2
PARALLELOGRAM = 3
VOLUMETRIC = 4


@dataclasses.dataclass
class ParallelogramLight:
    """Area light spanned by (v1, v2) from `corner`; each field is [3] f32."""
    corner: torch.Tensor
    v1: torch.Tensor
    v2: torch.Tensor
    normal: torch.Tensor
    emission: torch.Tensor

    @classmethod
    def make(cls, corner, v1, v2, emission, device):
        def vec(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device)

        v1, v2 = vec(v1), vec(v2)
        return cls(corner=vec(corner), v1=v1, v2=v2,
                   normal=normalize(cross(v1, v2)), emission=vec(emission))

    @property
    def area(self):
        return length(cross(self.v1, self.v2))


@dataclasses.dataclass
class LightTable:
    """The simple lights as planes (shade/lights.py:55-95): `position` is the
    direction the light travels for a DIRECTIONAL light; `radius` applies to
    VOLUMETRIC lights only; `falloff` 0 / 1 / 2 is constant, 1/d, 1/d²."""
    kind: torch.Tensor       # [L] int32
    position: torch.Tensor   # [L, 3]
    color: torch.Tensor      # [L, 3]
    falloff: torch.Tensor    # [L] int32
    radius: torch.Tensor     # [L]

    @classmethod
    def make(cls, lights, device):
        """lights: list of dicts with keys kind, position (or direction),
        color, falloff, radius. An empty list still makes one light, a
        zero-color POINT light at the origin, which the Whitted integrator
        samples and shadow-tests like any other."""
        n = max(len(lights), 1)
        kind = np.zeros(n, np.int32)
        pos = np.zeros((n, 3), np.float32)
        col = np.zeros((n, 3), np.float32)
        fall = np.zeros(n, np.int32)
        rad = np.zeros(n, np.float32)
        for i, light in enumerate(lights):
            kind[i] = light["kind"]
            pos[i] = light.get("position", light.get("direction", (0, 0, 0)))
            col[i] = light["color"]
            fall[i] = light.get("falloff", 0)
            rad[i] = light.get("radius", 0.0)
        return cls(*(torch.as_tensor(a, device=device)
                     for a in (kind, pos, col, fall, rad)))

    @property
    def num(self):
        return self.kind.shape[0]


def sample_light(table: LightTable, i: int, hit_pos, rng_state):
    """Direction and radiance toward light `i` from `hit_pos` [..., 3]
    (shade/lights.py:97-136) → (wi, dist, radiance, is_ambient, rng_state).

    Every lane draws two uniform pairs, whatever the light's kind: the first
    pair and the first value of the second jitter a VOLUMETRIC light's
    target in its radius ball. A DIRECTIONAL light shines along `position`
    (wi = -normalize(position), dist 1e16); the falloff divides by the
    distance to the target point (clamped at 1e-6) for the other kinds but
    AMBIENT."""
    from .sampling import uniform_sample_sphere
    kind = table.kind[i]
    pos = table.position[i]
    falloff = table.falloff[i]

    u1, u2, rng_state = _rng.uniform2(rng_state)
    u3, _, rng_state = _rng.uniform2(rng_state)
    jitter = (uniform_sample_sphere(u1, u2)
              * torch.pow(u3, 1.0 / 3.0)[..., None] * table.radius[i])
    target = pos + torch.where(kind == VOLUMETRIC, 1.0, 0.0) * jitter
    delta = target - hit_pos
    dist_point = length(delta)
    wi_point = delta / torch.clamp_min(dist_point, 1e-12)[..., None]

    is_directional = kind == DIRECTIONAL
    is_ambient = (kind == AMBIENT).expand(dist_point.shape)
    wi = torch.where(is_directional, (-normalize(pos)).expand(hit_pos.shape),
                     wi_point)
    dist = torch.where(is_directional, 1e16, dist_point)
    atten = torch.where(
        falloff == 0, 1.0,
        torch.where(falloff == 1, 1.0 / torch.clamp_min(dist_point, 1e-6),
                    1.0 / torch.clamp_min(dist_point * dist_point, 1e-6)))
    atten = torch.where(is_directional | is_ambient, 1.0, atten)
    return wi, dist, table.color[i] * atten[..., None], is_ambient, rng_state
