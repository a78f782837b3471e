"""Ray and hit batches as dataclasses of tensors (counterpart of `core/rays.py`)."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Rays:
    """origin/direction: [..., 3] float32; tmin/tmax: [...] float32."""
    origin: torch.Tensor
    direction: torch.Tensor
    tmin: torch.Tensor
    tmax: torch.Tensor

    @property
    def batch_shape(self):
        return self.tmin.shape

    @classmethod
    def make(cls, origin, direction, tmin=1e-4, tmax=1e16):
        origin = torch.as_tensor(origin, dtype=torch.float32)
        direction = torch.as_tensor(direction, dtype=torch.float32,
                                    device=origin.device)
        bs = origin.shape[:-1]

        def plane(v):
            if isinstance(v, (int, float)):
                # filled on the device: a Python number through as_tensor
                # is a host-to-device copy, which waits for the device
                v = torch.full((), v, dtype=torch.float32,
                               device=origin.device)
            return torch.as_tensor(v, dtype=torch.float32,
                                   device=origin.device).expand(bs)

        return cls(origin=origin, direction=direction,
                   tmin=plane(tmin), tmax=plane(tmax))

    def at(self, t):
        """origin + t * direction."""
        return self.origin + t[..., None] * self.direction

    def reshape(self, *shape):
        """The same rays over a new batch shape."""
        shape = tuple(shape)
        return Rays(origin=self.origin.reshape(shape + (3,)),
                    direction=self.direction.reshape(shape + (3,)),
                    tmin=self.tmin.reshape(shape),
                    tmax=self.tmax.reshape(shape))


@dataclasses.dataclass
class Hits:
    """Closest-hit records: t (tmax on a miss); prim_id / inst_id / mat_id
    int32 (-1 on a miss); uv [..., 2] barycentrics; normal [..., 3] unit
    geometric normal."""
    t: torch.Tensor
    prim_id: torch.Tensor
    inst_id: torch.Tensor
    mat_id: torch.Tensor
    uv: torch.Tensor
    normal: torch.Tensor

    @property
    def valid(self):
        return self.prim_id >= 0
