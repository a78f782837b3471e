"""The Cornell box and its camera (counterpart of `scene/builtins.py:18-141`).

The data tables are a copy of the JAX package's (a CPU test holds them
equal): the JAX module cannot be imported without JAX.
"""
from __future__ import annotations

import numpy as np

from ..core.camera import Camera
from ..shade import materials as mat
from ..shade.lights import ParallelogramLight
from .device_scene import DeviceScene, make_device_scene

# Material ids for the Cornell box
WHITE, GREEN, RED, LIGHT = 0, 1, 2, 3

CORNELL_MATERIALS = [
    {"kind": mat.DIFFUSE, "base_color": (0.80, 0.80, 0.80)},                     # white
    {"kind": mat.DIFFUSE, "base_color": (0.05, 0.80, 0.05)},                     # green
    {"kind": mat.DIFFUSE, "base_color": (0.80, 0.05, 0.05)},                     # red
    {"kind": mat.DIFFUSE, "base_color": (0.78, 0.78, 0.78),
     "emission": (15.0, 15.0, 15.0)},                                            # lamp
]

# Quads as (4 corner points, material): the classic Cornell measurement data.
_CORNELL_QUADS = [
    # floor
    ([(552.8, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 559.2), (549.6, 0.0, 559.2)], WHITE),
    # ceiling
    ([(556.0, 548.8, 0.0), (556.0, 548.8, 559.2), (0.0, 548.8, 559.2), (0.0, 548.8, 0.0)], WHITE),
    # back wall
    ([(549.6, 0.0, 559.2), (0.0, 0.0, 559.2), (0.0, 548.8, 559.2), (556.0, 548.8, 559.2)], WHITE),
    # right wall (green)
    ([(0.0, 0.0, 559.2), (0.0, 0.0, 0.0), (0.0, 548.8, 0.0), (0.0, 548.8, 559.2)], GREEN),
    # left wall (red)
    ([(552.8, 0.0, 0.0), (549.6, 0.0, 559.2), (556.0, 548.8, 559.2), (556.0, 548.8, 0.0)], RED),
    # short block
    ([(130.0, 165.0, 65.0), (82.0, 165.0, 225.0), (240.0, 165.0, 272.0), (290.0, 165.0, 114.0)], WHITE),
    ([(290.0, 0.0, 114.0), (290.0, 165.0, 114.0), (240.0, 165.0, 272.0), (240.0, 0.0, 272.0)], WHITE),
    ([(130.0, 0.0, 65.0), (130.0, 165.0, 65.0), (290.0, 165.0, 114.0), (290.0, 0.0, 114.0)], WHITE),
    ([(82.0, 0.0, 225.0), (82.0, 165.0, 225.0), (130.0, 165.0, 65.0), (130.0, 0.0, 65.0)], WHITE),
    ([(240.0, 0.0, 272.0), (240.0, 165.0, 272.0), (82.0, 165.0, 225.0), (82.0, 0.0, 225.0)], WHITE),
    # tall block
    ([(423.0, 330.0, 247.0), (265.0, 330.0, 296.0), (314.0, 330.0, 456.0), (472.0, 330.0, 406.0)], WHITE),
    ([(423.0, 0.0, 247.0), (423.0, 330.0, 247.0), (472.0, 330.0, 406.0), (472.0, 0.0, 406.0)], WHITE),
    ([(472.0, 0.0, 406.0), (472.0, 330.0, 406.0), (314.0, 330.0, 456.0), (314.0, 0.0, 456.0)], WHITE),
    ([(314.0, 0.0, 456.0), (314.0, 330.0, 456.0), (265.0, 330.0, 296.0), (265.0, 0.0, 296.0)], WHITE),
    ([(265.0, 0.0, 296.0), (265.0, 330.0, 296.0), (423.0, 330.0, 247.0), (423.0, 0.0, 247.0)], WHITE),
    # ceiling light (slightly below the ceiling)
    ([(343.0, 548.6, 227.0), (213.0, 548.6, 227.0), (213.0, 548.6, 332.0), (343.0, 548.6, 332.0)], LIGHT),
]

CORNELL_LIGHT_CORNER = (343.0, 548.6, 227.0)
CORNELL_LIGHT_V1 = (-130.0, 0.0, 0.0)
CORNELL_LIGHT_V2 = (0.0, 0.0, 105.0)
CORNELL_LIGHT_EMISSION = (15.0, 15.0, 15.0)


def quads_to_triangles(quads):
    """[(4 points, mat_id)] → (vertices [V,3], indices [2Q,3], tri_mat [2Q])."""
    verts, idx, tri_mat = [], [], []
    for corners, m in quads:
        base = len(verts)
        verts.extend(corners)
        idx.append((base + 0, base + 1, base + 2))
        idx.append((base + 0, base + 2, base + 3))
        tri_mat.extend([m, m])
    return (np.asarray(verts, np.float32), np.asarray(idx, np.int32),
            np.asarray(tri_mat, np.int32))


def cornell_box(device) -> DeviceScene:
    verts, idx, tri_mat = quads_to_triangles(_CORNELL_QUADS)
    light = ParallelogramLight.make(
        CORNELL_LIGHT_CORNER, CORNELL_LIGHT_V1, CORNELL_LIGHT_V2,
        CORNELL_LIGHT_EMISSION, device)
    return make_device_scene(verts, idx, tri_mat, CORNELL_MATERIALS, device,
                             area_light=light, miss_color=(0.0, 0.0, 0.0))


def cornell_camera(width, height) -> Camera:
    """The classic Cornell viewpoint: eye in front of the open face, 35°
    vertical field of view."""
    return Camera(eye=(278.0, 273.0, -900.0), lookat=(278.0, 273.0, 330.0),
                  up=(0.0, 1.0, 0.0), fov_y=35.0, aspect=width / height)
