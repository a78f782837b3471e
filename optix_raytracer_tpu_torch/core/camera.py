"""Pinhole / thin-lens / orthographic camera (counterpart of `core/camera.py`).

`Camera` is the host-side description; `params(device)` gives the launch
block as tensors; `generate_rays` is the batched `__raygen__pinhole` with
jittered progressive sampling; `Trackball` moves a Camera from mouse and
key input (the viewer's).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import telemetry
from . import rng as _rng
from .rays import Rays
from .vecmath import normalize


@dataclasses.dataclass
class Camera:
    """Host-side camera description (mutable, like `sutil::Camera`)."""
    eye: tuple = (0.0, 0.0, 1.0)
    lookat: tuple = (0.0, 0.0, 0.0)
    up: tuple = (0.0, 1.0, 0.0)
    fov_y: float = 35.0          # degrees
    aspect: float = 1.0
    aperture: float = 0.0        # lens radius; 0 = pinhole
    focal_distance: float = 1.0  # only used when aperture > 0
    orthographic: bool = False
    ortho_height: float = 2.0

    def uvw_frame(self):
        """U, V, W basis; |W| is the focal length (`sutil/Camera.cpp`)."""
        eye = np.asarray(self.eye, np.float32)
        lookat = np.asarray(self.lookat, np.float32)
        up = np.asarray(self.up, np.float32)
        w = lookat - eye
        wlen = np.linalg.norm(w)
        u = np.cross(w, up)
        u /= max(np.linalg.norm(u), 1e-20)
        v = np.cross(u, w)
        v /= max(np.linalg.norm(v), 1e-20)
        vlen = wlen * math.tan(0.5 * math.radians(self.fov_y))
        ulen = vlen * self.aspect
        return u * ulen, v * vlen, w

    def params(self, device):
        """Launch parameters as a dict of tensors on `device`."""
        u, v, w = self.uvw_frame()
        return camera_params_from_numpy(dict(
            eye=np.asarray(self.eye, np.float32), U=u, V=v, W=w,
            aperture=self.aperture, focal_distance=self.focal_distance,
            ortho=1 if self.orthographic else 0,
            ortho_half=[0.5 * self.ortho_height * self.aspect,
                        0.5 * self.ortho_height]), device)


def camera_params_from_numpy(params, device):
    """Camera params dict of arrays (e.g. the JAX `Camera.params()` converted
    with numpy) → the same dict of tensors on `device` (the `camera.params`
    span)."""
    with telemetry.span("camera.params"):
        out = {k: torch.as_tensor(np.asarray(params[k], np.float32),
                                  device=device)
               for k in ("eye", "U", "V", "W", "aperture", "focal_distance",
                         "ortho_half")}
        out["ortho"] = torch.as_tensor(np.asarray(params["ortho"], np.int32),
                                       device=device)
    return out


def generate_rays(cam_params, width, height, rng_state=None, jitter=True,
                  y0=0, full_width=None, full_height=None, y_stride=1):
    """Camera rays for a [height, width] pixel grid → (Rays, next_rng_state).

    NDC d = 2*(idx + jitter)/dim - 1, direction = d.x*U + d.y*V + W. The
    thin-lens pair is drawn whenever an RNG state is given, even for a
    pinhole, so the stream stays in step with the engine and the kernel.
    (y0, full_*) select a row tile of a larger frame; y_stride > 1 takes
    every y_stride-th row from y0 (the multichip layer's interleaved rows,
    camera.py:81-82).
    """
    device = cam_params["eye"].device
    full_w = width if full_width is None else full_width
    full_h = height if full_height is None else full_height
    ix = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    iy = (torch.arange(height, dtype=torch.float32, device=device)[:, None]
          * y_stride + y0)
    ix = ix.expand(height, width)
    iy = iy.expand(height, width)

    if jitter and rng_state is not None:
        jx, jy, rng_state = _rng.uniform2(rng_state)
    else:
        jx = jy = 0.5

    # NDC in [-1, 1]; image row 0 is the top, so y flips. The frame size is
    # a device tensor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which rounds differently from a true division (the
    # fused kernel's) unless the size is a power of two.
    fw = torch.full((), full_w, dtype=torch.float32, device=device)
    fh = torch.full((), full_h, dtype=torch.float32, device=device)
    dx = 2.0 * ((ix + jx) / fw) - 1.0
    dy = 1.0 - 2.0 * ((iy + jy) / fh)

    U, V, W = cam_params["U"], cam_params["V"], cam_params["W"]
    eye = cam_params["eye"]

    direction = normalize(dx[..., None] * U + dy[..., None] * V + W)
    origin = eye.expand(direction.shape)

    # Orthographic: the origin slides on the image plane along unit U, V.
    ohx, ohy = cam_params["ortho_half"][0], cam_params["ortho_half"][1]
    un, vn = normalize(U), normalize(V)
    ortho_origin = eye + (dx * ohx)[..., None] * un + (dy * ohy)[..., None] * vn
    ortho_dir = normalize(W).expand(direction.shape)
    is_ortho = cam_params["ortho"] > 0
    origin = torch.where(is_ortho, ortho_origin, origin)
    direction = torch.where(is_ortho, ortho_dir, direction)

    # Thin-lens depth of field: jitter the origin on the lens disk and
    # re-aim at the focal point.
    if rng_state is not None:
        aperture = cam_params["aperture"]
        u1, u2, rng_state = _rng.uniform2(rng_state)
        r = torch.sqrt(u1) * aperture
        phi = 2.0 * math.pi * u2
        lens = (r * torch.cos(phi))[..., None] * un + (r * torch.sin(phi))[..., None] * vn
        focus = origin + cam_params["focal_distance"] * direction
        dof_origin = origin + lens
        dof_direction = normalize(focus - dof_origin)
        use_dof = aperture > 0.0
        origin = torch.where(use_dof, dof_origin, origin)
        direction = torch.where(use_dof, dof_direction, direction)

    return Rays.make(origin, direction), rng_state


class Trackball:
    """Mouse-orbit / pan / zoom / WASDQE camera controller (counterpart of
    `core/camera.py:136-207`, the behaviour of `SDK/sutil/Trackball.{h,cpp}`):
    spherical-coordinate orbit about the look-at point with gimbal-lock
    clamping, wheel zoom toward the look-at point, pan in the image plane and
    the WASDQE moves (`Trackball.h:54-66`). Host-side numpy; drives a
    `Camera` in place.
    """

    def __init__(self, camera: Camera, move_speed: float = 1.0):
        self.camera = camera
        self.move_speed = move_speed
        self._latitude = 0.0
        self._longitude = 0.0
        self.reinitialize_orientation()

    def reinitialize_orientation(self):
        eye = np.asarray(self.camera.eye, np.float64)
        lookat = np.asarray(self.camera.lookat, np.float64)
        d = eye - lookat
        r = np.linalg.norm(d)
        if r < 1e-12:
            self._latitude = self._longitude = 0.0
            return
        self._latitude = math.asin(np.clip(d[1] / r, -1.0, 1.0))
        self._longitude = math.atan2(d[0], d[2])

    def _apply(self):
        eye = np.asarray(self.camera.eye, np.float64)
        lookat = np.asarray(self.camera.lookat, np.float64)
        r = np.linalg.norm(eye - lookat)
        lat, lon = self._latitude, self._longitude
        d = np.array([math.cos(lat) * math.sin(lon),
                      math.sin(lat),
                      math.cos(lat) * math.cos(lon)])
        self.camera.eye = tuple(lookat + r * d)

    def orbit(self, dx_pixels: float, dy_pixels: float, per_pixel=0.005):
        """Rotate the eye about the lookat point (Trackball.cpp updateCamera)."""
        self._longitude = (self._longitude - dx_pixels * per_pixel) % (2 * math.pi)
        self._latitude = float(np.clip(self._latitude + dy_pixels * per_pixel,
                                       -0.5 * math.pi + 0.001, 0.5 * math.pi - 0.001))
        self._apply()

    def zoom(self, direction: int, factor: float = 0.9):
        """Wheel zoom: move the eye toward/away from the lookat."""
        eye = np.asarray(self.camera.eye, np.float64)
        lookat = np.asarray(self.camera.lookat, np.float64)
        scale = factor if direction > 0 else 1.0 / factor
        self.camera.eye = tuple(lookat + (eye - lookat) * scale)

    def pan(self, dx: float, dy: float):
        """Translate eye and lookat in the image plane."""
        u, v, _ = self.camera.uvw_frame()
        u = u / max(np.linalg.norm(u), 1e-20)
        v = v / max(np.linalg.norm(v), 1e-20)
        delta = (-dx * u + dy * v) * self.move_speed
        self.camera.eye = tuple(np.asarray(self.camera.eye) + delta)
        self.camera.lookat = tuple(np.asarray(self.camera.lookat) + delta)

    def move(self, key: str, dt: float = 0.1):
        """WASDQE flythrough moves (Trackball.h:54-66 keyEvent mapping)."""
        u, v, w = self.camera.uvw_frame()
        u = u / max(np.linalg.norm(u), 1e-20)
        v = v / max(np.linalg.norm(v), 1e-20)
        w = w / max(np.linalg.norm(w), 1e-20)
        step = {"w": w, "s": -w, "a": -u, "d": u, "q": -v, "e": v}.get(key.lower())
        if step is None:
            return
        delta = step * self.move_speed * dt
        self.camera.eye = tuple(np.asarray(self.camera.eye) + delta)
        self.camera.lookat = tuple(np.asarray(self.camera.lookat) + delta)
