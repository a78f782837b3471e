"""The one traffic generator: a mix's parameters (`traffic/<name>.json`) and
the seed → the camera of every launch and the pixels the check reads.

A launch's camera is the configuration's, turned about the vertical axis
through its look-at point by

    angle(k) = offset + amplitude * tri(phase + k / period)   (degrees)

where tri is the triangle wave of period 1 between -1 and 1 (a constant
angular speed of 4 amplitude / period a launch, reversing at the ends), and
the seed draws offset uniformly in [-offset_deg, offset_deg] and phase in
[0, 1). Every seed thus sees the same set of views in another order, or,
with amplitude 0, one still view close to the configuration's.
"""
from __future__ import annotations

import math

import numpy as np

CAMERA_STREAM, PIXEL_STREAM = 0, 1


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % 2 ** 64, stream]))


class CameraPath:
    def __init__(self, camera: dict, orbit: dict, seed: int):
        rng = _rng(seed, CAMERA_STREAM)
        self.camera = camera
        self.offset = float(rng.uniform(-orbit["offset_deg"],
                                        orbit["offset_deg"]))
        self.phase = float(rng.uniform(0.0, 1.0))
        self.amplitude = float(orbit["amplitude_deg"])
        self.period = float(orbit["period_launches"])

    def angle(self, k: int) -> float:
        x = (self.phase + k / self.period) % 1.0
        return self.offset + self.amplitude * (4.0 * abs(x - 0.5) - 1.0)

    def eye(self, k: int) -> tuple:
        """The eye of launch k (float64), the rest of the camera unchanged."""
        a = math.radians(self.angle(k))
        eye = np.asarray(self.camera["eye"], np.float64)
        at = np.asarray(self.camera["lookat"], np.float64)
        x, y, z = eye - at
        c, s = math.cos(a), math.sin(a)
        return tuple(float(v) for v in at + (c * x + s * z, y, -s * x + c * z))


def pixels(width: int, height: int, count: int, seed: int, sets: int = 1):
    """`sets` stratified samples of about `count` pixels each: the frame cut
    into a grid of about count cells, one pixel drawn in each → (px [S, P],
    py [S, P], area [S, P]: each cell's pixels, so each row of area sums to
    width * height). Launch k of a run is read at set k % sets."""
    rng = _rng(seed, PIXEL_STREAM)
    gx = max(1, round(math.sqrt(count * width / height)))
    gy = max(1, count // gx)
    xs = np.linspace(0, width, gx + 1).round().astype(np.int64)
    ys = np.linspace(0, height, gy + 1).round().astype(np.int64)
    x0, y0 = np.meshgrid(xs[:-1], ys[:-1])
    x1, y1 = np.meshgrid(xs[1:], ys[1:])
    x0, y0, x1, y1 = (a.ravel() for a in (x0, y0, x1, y1))
    px = rng.integers(x0, x1, size=(sets, x0.size))
    py = rng.integers(y0, y1, size=(sets, y0.size))
    area = np.broadcast_to(((x1 - x0) * (y1 - y0)).astype(np.float64),
                           px.shape)
    return px.astype(np.int64), py.astype(np.int64), np.array(area)
