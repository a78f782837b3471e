"""Motion blur, curves and volumes: the six apps' default frames, shared by
chip_smoke.py (phases v1-v3), tools/profile_torch_port.py (--scene motion,
hair, volume) and the card tests; the camera rays of a crop of a frame, as
the apps generate them for the whole frame; and a recorded brute-force
query held, kernel against plain version, bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from ..accel import pallas_bf
from ..core import rng as _rng
from ..core.camera import generate_rays
from ..core.rays import Rays

# Each app's frame as its main() renders it by default (the reference apps'
# defaults; the engine modes' depths are render_engine's).
MOTION_BLUR = dict(width=512, height=512, spl=32, depth=2)
MOTION_GEOMETRY = dict(width=512, height=512, spl=32)
CURVES = dict(width=512, height=512, spl=8, depth=2, kind="cubic_bspline")
RIBBONS = dict(width=512, height=512, spl=8, depth=2)
HAIR = dict(width=512, height=512, spl=4, spline="cubic_bspline", swept=True)
VOLUME = dict(width=512, height=512, spl=4, res=64, steps=96)
VOLUME_ENGINE = dict(width=512, height=512, spl=4, res=48, depth=3)
# The crop a card's first sample is held against the CPU on: 64x64 at the
# frame's centre.
CROP = 64
# Bars of a crop, card against CPU: the apps' parity bars (atol 2e-3 /
# rtol 1e-3; 3e-3 where prims are shaded, tests/test_fused_kernel.py:238).
ATOL, ATOL_PRIMS, RTOL = 2e-3, 3e-3, 1e-3


def crop_at(width, height, size=CROP):
    return (height - size) // 2, (width - size) // 2


def crop_rays(cam, width, height, subframe, size=CROP):
    """The camera rays and RNG states of the centre size x size crop of
    sample `subframe` of a frame, generated for the whole frame on the
    camera's device as the apps generate them (the pixel-indexed seed and
    generate_rays' draws), then moved to the CPU → (Rays [size²], rng
    [size²]). A crop held against the CPU starts from the card's rays:
    torch's CPU sqrt (its AVX-512 path) rounds about 0.7% of values one
    ulp away from the correctly rounded ones the card gives, and a 1-ulp
    change of a camera ray can flip a swept span's hit: its coarse scan
    decides a hit at 17 sampled points of the curve."""
    dev = cam["eye"].device
    n = width * height
    rng = _rng.seed(torch.arange(n, dtype=torch.int64, device=dev),
                    subframe)
    rays, rng = generate_rays(cam, width, height,
                              rng_state=rng.reshape(height, width))
    y0, x0 = crop_at(width, height, size)
    sl = (slice(y0, y0 + size), slice(x0, x0 + size))
    return (Rays(origin=rays.origin[sl].reshape(-1, 3).cpu(),
                 direction=rays.direction[sl].reshape(-1, 3).cpu(),
                 tmin=rays.tmin[sl].reshape(-1).cpu(),
                 tmax=rays.tmax[sl].reshape(-1).cpu()),
            rng[sl].reshape(-1).cpu())


def crop(img, size=CROP):
    """The centre size x size crop of an [H, W, 3] image."""
    y0, x0 = crop_at(img.shape[1], img.shape[0], size)
    return img[y0:y0 + size, x0:x0 + size]


def outside_bar(out, ref, atol, rtol=RTOL):
    """Pixels of `out` outside atol / rtol of `ref` (numpy [..., 3]) →
    (count, the largest difference)."""
    out = np.asarray(out, np.float64).reshape(-1, 3)
    ref = np.asarray(ref, np.float64).reshape(-1, 3)
    assert out.shape == ref.shape
    bad = (np.abs(out - ref) > atol + rtol * np.abs(ref)).any(axis=1)
    return int(bad.sum()), float(np.abs(out - ref).max())


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def bf_query_parity(call):
    """A brute-force query recorded by whitted_probe.recorded_queries, on
    its device: its kernel (1 or 2; the plain version on the CPU) against
    the plain version, bit for bit → dict(kind, rays, live, bit_equal)."""
    rays, tc = call["rays"], call["tri_consts"]
    if call["kind"] == "closest":
        out = pallas_bf.closest_hit(tc, call["tri_mat"], rays)
        ref = pallas_bf.closest_hit_plain(tc, call["tri_mat"], rays)
        equal = all(torch.equal(_bits(out[k]), _bits(ref[k])) for k in ref)
    else:
        equal = torch.equal(pallas_bf.any_hit(tc, rays),
                            pallas_bf.any_hit_plain(tc, rays))
    return dict(kind=call["kind"], rays=int(rays.tmin.numel()),
                live=int((rays.tmax > rays.tmin).sum()), bit_equal=equal)
