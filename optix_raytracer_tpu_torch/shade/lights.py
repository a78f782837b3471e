"""The parallelogram area light (counterpart of `shade/lights.py:27-52`)."""
from __future__ import annotations

import dataclasses

import torch

from ..core.vecmath import cross, length, normalize


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
