"""Film: progressive accumulation buffer, sRGB output and the host-facing
framebuffer `OutputBuffer` (counterpart of `core/film.py`)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import telemetry


@dataclasses.dataclass
class Film:
    """Progressive-render state.

    accum: [H, W, 3] float32 running mean of linear radiance. subframe:
    int64 scalar tensor on the device, the samples accumulated so far; it
    seeds the RNG of the next launch and is never read back to the host.
    With `track_variance`, `sq` holds the running mean of squared per-launch
    estimates and `launches` counts launches (the engine's `_merge_launch`).
    """
    accum: torch.Tensor
    subframe: torch.Tensor
    sq: Optional[torch.Tensor] = None
    launches: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, height, width, device, track_variance: bool = False):
        def zeros3():
            return torch.zeros((height, width, 3), dtype=torch.float32,
                               device=device)

        def zero_int():
            return torch.zeros((), dtype=torch.int64, device=device)

        return cls(accum=zeros3(), subframe=zero_int(),
                   sq=zeros3() if track_variance else None,
                   launches=zero_int() if track_variance else None)

    def accumulate(self, radiance):
        """One progressive step (core/film.py:52-66): accum += (radiance -
        accum) / (subframe + 1), and with variance tracking the running
        mean of radiance² over launches → the next Film."""
        t = 1.0 / (self.subframe.to(torch.float32) + 1.0)
        sq, launches = self.sq, self.launches
        if sq is not None:
            tl = 1.0 / (launches.to(torch.float32) + 1.0)
            sq = sq + (radiance * radiance - sq) * tl
            launches = launches + 1
        return Film(accum=self.accum + (radiance - self.accum) * t,
                    subframe=self.subframe + 1, sq=sq, launches=launches)

    def variance_of_mean(self):
        """Per-pixel stderr² of `accum` (None when tracking is off) over L
        equal-spp launches (core/film.py:67-78): `sq - accum²` is the
        biased variance v_b; the unbiased sample variance is v_b L/(L-1)
        and Var(mean) = s²/L, so the two L factors cancel to v_b/(L-1)."""
        if self.sq is None:
            return None
        L = self.launches.to(torch.float32)
        var_est = torch.clamp_min(self.sq - self.accum * self.accum, 0.0)
        return var_est / torch.clamp_min(L - 1.0, 1.0)

    def reset(self):
        """Camera moved or resized: restart accumulation (core/film.py:
        80-86); each field keeps its dtype and device (the `film.reset`
        span)."""
        def zero(t):
            return None if t is None else torch.zeros_like(t)

        with telemetry.span("film.reset"):
            return Film(accum=zero(self.accum), subframe=zero(self.subframe),
                        sq=zero(self.sq), launches=zero(self.launches))


def linear_to_srgb(c):
    """Exact sRGB OETF (reference `cuda/helpers.h:37-42`)."""
    c = torch.clamp(c, 0.0, 1.0)
    lo = 12.92 * c
    hi = 1.055 * torch.pow(torch.clamp_min(c, 1e-8), 1.0 / 2.4) - 0.055
    return torch.where(c < 0.0031308, lo, hi)


def srgb_to_linear(c):
    """Inverse sRGB OETF (core/film.py:97-101)."""
    c = torch.clamp(c, 0.0, 1.0)
    lo = c / 12.92
    hi = torch.pow((c + 0.055) / 1.055, 2.4)
    return torch.where(c < 0.04045, lo, hi)


def make_color(radiance):
    """Linear radiance [..., 3] → uint8 RGBA, sRGB-encoded, with the
    reference's `quantizeUnsigned8Bits` rounding (x * 255.99999, floor)."""
    srgb = linear_to_srgb(radiance)
    rgb = torch.clamp(srgb * 255.99999, 0.0, 255.0).to(torch.uint8)
    alpha = torch.full(rgb.shape[:-1] + (1,), 255, dtype=torch.uint8,
                       device=rgb.device)
    return torch.cat([rgb, alpha], dim=-1)


class OutputBuffer:
    """Host-facing framebuffer (counterpart of `core/film.py:122-150`, the
    `CUDAOutputBuffer<uchar4>` role, `sutil/CUDAOutputBuffer.h:45-94`): a
    uint8 RGBA [H, W, 4] tensor on `device`, copied to the host by
    `get_host`. `map` / `unmap` stay as the sample code's access points."""

    def __init__(self, width: int, height: int, device="cpu"):
        self.width = int(width)
        self.height = int(height)
        self.device = torch.device(device)
        self._device = torch.zeros((self.height, self.width, 4),
                                   dtype=torch.uint8, device=self.device)

    def map(self):
        return self._device

    def unmap(self):
        pass

    def set(self, device_rgba):
        self._device = device_rgba

    def get_host(self) -> np.ndarray:
        return self._device.cpu().numpy()

    def resize(self, width: int, height: int):
        if (width, height) != (self.width, self.height):
            self.__init__(width, height, self.device)
