"""Checkpoint and resume of a progressive render (counterpart of
`core/checkpoint.py:26-70`).

The film (running mean, subframe count, and with variance tracking the
running mean of squares and the launch count), the camera and a user config
round-trip through one .npz in the JAX package's format (version 1), so a
file that either package writes loads and resumes in the other. The JAX
film counts in int32 and the port's in int64: the writer stores int32 and
the loader widens. The sharded Orbax pair of the reference waits for the
multichip layer (ROADMAP.md Queue 1 item 12).
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from .camera import Camera
from .film import Film

FORMAT_VERSION = 1


def _count32(t) -> np.ndarray:
    v = int(t)
    if not -2 ** 31 <= v < 2 ** 31:
        raise ValueError(f"count {v} does not fit the format's int32")
    return np.asarray(v, np.int32)


def save_checkpoint(path: str, film: Film, camera: Camera = None,
                    config: dict = None):
    """Write the film, camera and config to `path` (.npz)."""
    camera_json = (json.dumps(dataclasses.asdict(camera))
                   if camera is not None else "")
    extra = {}
    if film.sq is not None:
        extra["sq"] = film.sq.detach().cpu().numpy()
        extra["launches"] = _count32(film.launches)
    np.savez_compressed(
        path, version=FORMAT_VERSION,
        accum=film.accum.detach().cpu().numpy(),
        subframe=_count32(film.subframe), camera_json=camera_json,
        config_json=json.dumps(config or {}), **extra)


def load_checkpoint(path: str, device):
    """→ (Film on `device`, Camera or None, config dict)."""
    def counter(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    with np.load(path, allow_pickle=False) as z:
        if int(z["version"]) != FORMAT_VERSION:
            raise ValueError(f"{path}: checkpoint version {int(z['version'])}"
                             f", expected {FORMAT_VERSION}")
        film = Film(
            accum=torch.as_tensor(np.asarray(z["accum"], np.float32),
                                  device=device),
            subframe=counter(z["subframe"]),
            sq=(torch.as_tensor(np.asarray(z["sq"], np.float32),
                                device=device) if "sq" in z.files else None),
            launches=counter(z["launches"]) if "launches" in z.files
            else None)
        cam_js = str(z["camera_json"])
        camera = None
        if cam_js:
            d = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in json.loads(cam_js).items()}
            camera = Camera(**d)
        config = json.loads(str(z["config_json"]))
    return film, camera, config
